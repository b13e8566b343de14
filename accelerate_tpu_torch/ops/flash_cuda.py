"""Flash attention on Hopper: the wrappers of the kernels in ``csrc/``,
their plain PyTorch versions, and the autograd function that joins them.

* :func:`flash_fwd` replaces the TPU kernel
  ``accelerate_tpu/ops/flash_pallas.py::_fwd_kernel`` (launched by
  ``_flash_fwd``): tiled online-softmax attention in f32 with causal,
  sliding-window (banded: only the key tiles of the band are visited),
  segment-id and Gemma2 softcap masks, an ``sm_scale`` override and GQA by
  index, returning ``(out, lse)``. The TPU kernel broadcast lse over 128
  lanes; here it is stored once per row, ``[B, H, Sq]`` f32.
* :func:`flash_bwd` replaces ``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel``
  (launched by ``_flash_bwd``): it computes ``delta = rowsum(dO * O)`` in
  f32 as plain torch (JAX does it in XLA, outside Pallas), then launches the
  dK/dV kernel and the dQ kernel.
* :class:`FlashAttentionFunction` is the ``custom_vjp`` of ``_flash_bhsd`` /
  ``_flash_bhsd_seg``: forward through :func:`flash_fwd`, backward through
  :func:`flash_bwd`.

Two routes for each kernel, picked by :func:`_wgmma_route` from the kernel,
the dtype and the head_dim alone, before any launch. 16-bit inputs take the
``wgmma`` kernels (TMA into shared-memory rings under mbarriers, two
warpgroups of products) at the head_dims each was built for: the forward
(``csrc/flash_fwd_sm90.cu``), dK/dV (``csrc/flash_bwd_dkdv_sm90.cu``) and
dQ (``csrc/flash_bwd_dq_sm90.cu``) all at 64, 80, 96, 128 and 256.
Everything else (float32, and the other head_dims from 16 to 256) takes the
``mma.sync`` kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``). A
backward call runs dK/dV and then dQ, each on its own route, one after the
other on the current stream; both read the same ``lse`` and ``delta``.
What bounds them: at the forward path's shape (Llama-3-8B widths, B=4,
S=2048, causal, bf16) a forward does ~137 GFLOP over ~169 MB moved, and at
the training shape (B=8, S=1024, H=16, G=8, D=128) the backward's two
kernels do ~69 and ~52 GFLOP, each over ~135 MB: the tensor-core rate
bounds all of them, at every head_dim; see the sources' headers.

For a CUDA tensor each wrapper launches its kernels or raises: a failed
build or launch is never retried on the other route. Only a tensor on the
CPU takes the plain version (:func:`flash_fwd_reference`,
:func:`flash_bwd_reference`).
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap):
    if sliding_window is not None and not causal:
        raise ValueError("sliding_window requires causal=True")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if segment_ids is not None and (q.shape[1] != k.shape[1]
                                    or tuple(segment_ids.shape) != (q.shape[0], q.shape[1])):
        raise ValueError("segment_ids must be [batch, seq] with equal q and k lengths")


def _pair_mask(q, k, causal, sliding_window, segment_ids):
    """Visible (q, k) pairs, ``[B or 1, 1, 1, Sq, Sk]`` bool (True = keep),
    or None when nothing is masked."""
    if not (causal or sliding_window is not None or segment_ids is not None):
        return None
    Sq, Sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    return mask[:, None, None]


def _scaled_logits(q, k, sm_scale, logit_softcap, acc):
    """``(s, s_cap)``: the logits [B, G, rep, Sq, Sk] in ``acc`` after the
    scale and the softcap (``s_cap`` is None without a softcap)."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    scale = D ** -0.5 if sm_scale is None else sm_scale
    qf = q.to(acc).reshape(B, Sq, G, H // G, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(acc)) * scale
    if logit_softcap is None:
        return s, None
    s = logit_softcap * torch.tanh(s / logit_softcap)
    return s, s


def flash_fwd_reference(q, k, v, causal: bool = True, sm_scale=None, sliding_window=None,
                        segment_ids=None, logit_softcap=None):
    """Plain version of :func:`flash_fwd`: dense masked softmax in f32.

    Same arguments and results: q [B, Sq, H, D], k/v [B, Sk, G, D] with
    ``H = G * rep``; returns ``(out [B, Sq, H, D] in q's dtype, lse [B, H,
    Sq] f32)``. Masked logits take the finite ``NEG_INF`` and an empty row
    divides by 1, as the kernel does. float64 inputs compute (and return
    lse) in float64, for ``torch.autograd.gradcheck``."""
    _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap)
    B, Sq, H, D = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    s, _ = _scaled_logits(q, k, sm_scale, logit_softcap, acc)
    mask = _pair_mask(q, k, causal, sliding_window, segment_ids)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p, v.to(acc)) / l
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return out, lse


# C launchers of each csrc library and their pointer arguments; every
# launcher then takes dtype, B, H, G, Sq, Sk, D, sm_scale, softcap, causal,
# window and the stream.
_LAUNCHERS = {
    "flash_fwd": {"flash_fwd": 6},
    "flash_fwd_sm90": {"flash_fwd_sm90": 6},
    "flash_bwd": {"flash_bwd_dkdv": 9, "flash_bwd_dq": 8},
    "flash_bwd_dkdv_sm90": {"flash_bwd_dkdv_sm90": 9},
    "flash_bwd_dq_sm90": {"flash_bwd_dq_sm90": 8},
}
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
#: The head_dims each ``wgmma`` kernel was built for (its C launcher refuses
#: any other), the same for the three: each tiles 80 and 96 as a 64-column
#: panel and a 16- or 32-column tail, and 256 in 64-key tiles (in dK/dV and
#: dQ the two warpgroups split the head's columns).
_WGMMA_HEAD_DIMS = {kernel: (64, 80, 96, 128, 256) for kernel in ("forward", "dkdv", "dq")}


def _wgmma_route(kernel: str, dtype, head_dim: int) -> bool:
    """The route predicate of one kernel ("forward", "dkdv" or "dq"): True
    sends a call to its ``wgmma`` kernel (16-bit inputs at a head_dim of
    ``_WGMMA_HEAD_DIMS[kernel]``), False to its ``mma.sync`` kernel. It
    depends on the kernel, the dtype and the head_dim only."""
    return dtype in _WGMMA_DTYPES and head_dim in _WGMMA_HEAD_DIMS[kernel]


def _library(name: str):
    """The ctypes library of ``csrc/<name>.cu``, built at first use, with
    its C signatures set."""
    from ._build import load

    lib = load(name)
    error_string = getattr(lib, f"{name}_error_string")
    if error_string.restype is not ctypes.c_char_p:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        scalars = [i32] * 7 + [f32, f32, i32, i32, ptr]  # dtype, shape, options, stream
        for fn, count in _LAUNCHERS[name].items():
            getattr(lib, fn).argtypes = [ptr] * count + scalars
            getattr(lib, fn).restype = i32
        error_string.argtypes = [i32]
        error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(name, q, k, v, segment_ids, *others):
    """What the kernels take: one CUDA device, one kernel dtype, D % 16 == 0
    and D <= 256. ``others`` must match q's dtype too (out, d_out)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {q.device}")
    tensors = [q, k, v, *others] + ([segment_ids] if segment_ids is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor and segment_ids must be on one device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, *others)):
        raise TypeError(f"{name} takes float32/bfloat16/float16 tensors of one dtype, "
                        f"got {[t.dtype for t in (q, k, v, *others)]}")
    D = q.shape[-1]
    if D % 16 or D > MAX_HEAD_DIM:
        raise ValueError(f"{name} needs head_dim % 16 == 0 and <= {MAX_HEAD_DIM}, got {D}")


def _contiguous_aligned(name, *tensors):
    tensors = tuple(t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned operands")
    return tensors


def _launch(lib, name: str, fn: str, *args):
    """Calls kernel launcher ``fn`` of library ``name``; raises on a
    non-zero ``cudaGetLastError``."""
    err = getattr(lib, fn)(*args)
    if err:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {message}")


def flash_fwd(q, k, v, causal: bool = True, sm_scale=None, sliding_window=None,
              segment_ids=None, logit_softcap=None):
    """Flash-attention forward: ``(out, lse)``.

    q [B, Sq, H, D]; k/v [B, Sk, G, D] with ``H = G * rep`` (query head h
    reads kv head ``h // rep``); ``segment_ids`` [B, S] masks pairs from
    different segments; ``sliding_window=w`` keeps keys in ``(q - w, q]``
    and needs ``causal``; ``logit_softcap`` bounds logits by ``cap *
    tanh(s / cap)`` before the mask. Returns out [B, Sq, H, D] in q's dtype
    and lse [B, H, Sq] f32.

    A CUDA tensor launches a Hopper kernel (float32, bfloat16 or float16;
    ``D % 16 == 0`` and ``D <= 256``; the route by ``_wgmma_route("forward",
    ...)``) or
    raises; a CPU tensor takes :func:`flash_fwd_reference`.
    ``flash_fwd.launches`` counts the launches of both routes,
    ``flash_fwd.wgmma_launches`` and ``flash_fwd.mma_launches`` each route's."""
    _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                   sliding_window=sliding_window, segment_ids=segment_ids,
                                   logit_softcap=logit_softcap)
    _check_cuda("flash_fwd", q, k, v, segment_ids)
    launch = _fwd_wgmma if _wgmma_route("forward", q.dtype, q.shape[-1]) else _fwd_mma
    return launch(q, k, v, causal, sm_scale, sliding_window, segment_ids, logit_softcap)


def _fwd_launch(name, q, k, v, causal, sm_scale, sliding_window, segment_ids, logit_softcap):
    """Launches forward kernel ``name`` (one library, one C launcher of the
    same name) on checked CUDA operands; returns ``(out, lse)``."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    q, k, v = _contiguous_aligned("flash_fwd", q, k, v)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_library(name), name, name,
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if seg is None else seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
                _DTYPE_CODES[q.dtype], B, H, G, Sq, Sk, D,
                float(sm_scale), float(logit_softcap or 0.0), int(bool(causal)),
                int(sliding_window or 0), torch.cuda.current_stream().cuda_stream)
    flash_fwd.launches += 1
    return out, lse


def _fwd_wgmma(*args):
    """The forward on the ``wgmma`` route (``csrc/flash_fwd_sm90.cu``)."""
    result = _fwd_launch("flash_fwd_sm90", *args)
    flash_fwd.wgmma_launches += 1
    return result


def _fwd_mma(*args):
    """The forward on the ``mma.sync`` route (``csrc/flash_fwd.cu``)."""
    result = _fwd_launch("flash_fwd", *args)
    flash_fwd.mma_launches += 1
    return result


flash_fwd.launches = 0
flash_fwd.wgmma_launches = 0
flash_fwd.mma_launches = 0


def _check_residuals(q, out, lse, d_out):
    B, Sq, H, _ = q.shape
    if tuple(out.shape) != tuple(q.shape) or tuple(d_out.shape) != tuple(q.shape):
        raise ValueError(f"out {tuple(out.shape)} and d_out {tuple(d_out.shape)} must have "
                         f"q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse must be [B, H, Sq] = {(B, H, Sq)}, got {tuple(lse.shape)}")


def flash_bwd_reference(q, k, v, out, lse, d_out, causal: bool = True, sm_scale=None,
                        sliding_window=None, segment_ids=None, logit_softcap=None):
    """Plain version of :func:`flash_bwd`: the dense backward in f32.

    P is recomputed from ``lse`` exactly as the kernels do: ``exp(s - lse)``
    on visible pairs and 0 on masked ones. dV takes P rounded to the input
    dtype, dQ and dK take dS rounded to it (``_bwd_dkdv_kernel`` /
    ``_bwd_dq_kernel`` round the same way); the softcap chain uses the
    pre-mask capped logits. Returns ``(dq, dk, dv)`` in the inputs' dtypes;
    dk/dv sum the ``rep`` query heads of each kv head."""
    _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap)
    _check_residuals(q, out, lse, d_out)
    B, Sq, H, D = q.shape
    G = k.shape[2]
    rep = H // G
    scale = D ** -0.5 if sm_scale is None else sm_scale
    acc = torch.promote_types(q.dtype, torch.float32)
    s, s_cap = _scaled_logits(q, k, sm_scale, logit_softcap, acc)
    p = torch.exp(s - lse.to(acc).reshape(B, G, rep, Sq, 1))
    mask = _pair_mask(q, k, causal, sliding_window, segment_ids)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    qf = q.to(acc).reshape(B, Sq, G, rep, D)
    dof = d_out.to(acc).reshape(B, Sq, G, rep, D)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(q.dtype).to(acc), dof)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dof, v.to(acc))
    delta = (dof * out.to(acc).reshape(B, Sq, G, rep, D)).sum(-1)  # [B, Sq, G, rep]
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if s_cap is not None:
        ds = ds * (1.0 - torch.square(s_cap / logit_softcap))
    ds = (ds * scale).to(q.dtype).to(acc)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.to(acc)).reshape(B, Sq, H, D)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BackwardLaunch:
    """The two backward kernels' operands on the card, ready to launch:
    checked and laid out, ``delta = rowsum(dO * O)`` [B, H, Sq] computed in
    f32, the outputs allocated. :meth:`dkdv` and :meth:`dq` each launch one
    kernel on the current stream, each on its own route (``dkdv_wgmma`` and
    ``dq_wgmma``, from :func:`_wgmma_route`), and count it;
    :meth:`dkdv_wgmma`, :meth:`dkdv_mma`, :meth:`dq_wgmma` and :meth:`dq_mma`
    launch the kernel of one route."""

    def __init__(self, q, k, v, out, lse, d_out, causal, sm_scale, sliding_window,
                 segment_ids, logit_softcap):
        d_out = d_out.to(q.dtype)
        _check_cuda("flash_bwd", q, k, v, segment_ids, out, d_out)
        B, Sq, H, D = q.shape
        Sk, G = k.shape[1], k.shape[2]
        q, k, v, d_out = _contiguous_aligned("flash_bwd", q, k, v, d_out)
        self.delta = (d_out.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        self.lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
        self.seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
        self.operands = (q, k, v, d_out)  # kept alive until the launches are enqueued
        self.grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        self.inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
                       self.lse.data_ptr(), self.delta.data_ptr(),
                       None if self.seg is None else self.seg.data_ptr())
        self.shape = (_DTYPE_CODES[q.dtype], B, H, G, Sq, Sk, D,
                      float(D ** -0.5 if sm_scale is None else sm_scale),
                      float(logit_softcap or 0.0), int(bool(causal)), int(sliding_window or 0))
        self.device = q.device
        self.dkdv_on_wgmma = _wgmma_route("dkdv", q.dtype, D)
        self.dq_on_wgmma = _wgmma_route("dq", q.dtype, D)

    def _launch(self, name, fn, *outputs):
        with torch.cuda.device(self.device):
            _launch(_library(name), name, fn, *self.inputs, *(t.data_ptr() for t in outputs),
                    *self.shape, torch.cuda.current_stream().cuda_stream)

    def dkdv(self):
        (self.dkdv_wgmma if self.dkdv_on_wgmma else self.dkdv_mma)()

    def dkdv_wgmma(self):
        self._launch("flash_bwd_dkdv_sm90", "flash_bwd_dkdv_sm90", *self.grads[1:])
        flash_bwd.dkdv_launches += 1
        flash_bwd.dkdv_wgmma_launches += 1

    def dkdv_mma(self):
        self._launch("flash_bwd", "flash_bwd_dkdv", *self.grads[1:])
        flash_bwd.dkdv_launches += 1
        flash_bwd.dkdv_mma_launches += 1

    def dq(self):
        (self.dq_wgmma if self.dq_on_wgmma else self.dq_mma)()

    def dq_wgmma(self):
        self._launch("flash_bwd_dq_sm90", "flash_bwd_dq_sm90", self.grads[0])
        flash_bwd.dq_launches += 1
        flash_bwd.dq_wgmma_launches += 1

    def dq_mma(self):
        self._launch("flash_bwd", "flash_bwd_dq", self.grads[0])
        flash_bwd.dq_launches += 1
        flash_bwd.dq_mma_launches += 1


def flash_bwd(q, k, v, out, lse, d_out, causal: bool = True, sm_scale=None,
              sliding_window=None, segment_ids=None, logit_softcap=None):
    """Flash-attention backward: ``(dq, dk, dv)`` from the forward's inputs,
    its ``out`` and ``lse`` [B, H, Sq] f32, and the output gradient
    ``d_out``; the options are :func:`flash_fwd`'s.

    A CUDA tensor computes ``delta = rowsum(dO * O)`` [B, H, Sq] in f32 and
    launches the dK/dV kernel, then the dQ kernel, each on its own route of
    :func:`_wgmma_route` (no atomics: a repeat call gives bit-identical
    gradients), or raises; a CPU tensor takes :func:`flash_bwd_reference`.
    ``flash_bwd.dkdv_launches`` and ``flash_bwd.dq_launches`` count the
    launches of both routes, ``dkdv_wgmma_launches``, ``dkdv_mma_launches``,
    ``dq_wgmma_launches`` and ``dq_mma_launches`` each route's."""
    _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap)
    _check_residuals(q, out, lse, d_out)
    kw = dict(causal=causal, sm_scale=sm_scale, sliding_window=sliding_window,
              segment_ids=segment_ids, logit_softcap=logit_softcap)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, d_out, **kw)
    launch = _BackwardLaunch(q, k, v, out, lse, d_out, **kw)
    launch.dkdv()
    launch.dq()
    return launch.grads


flash_bwd.dkdv_launches = 0
flash_bwd.dkdv_wgmma_launches = 0
flash_bwd.dkdv_mma_launches = 0
flash_bwd.dq_launches = 0
flash_bwd.dq_wgmma_launches = 0
flash_bwd.dq_mma_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the ``custom_vjp`` of ``_flash_bhsd``
    / ``_flash_bhsd_seg``): forward through :func:`flash_fwd`, backward
    through :func:`flash_bwd`. Saves q, k, v, out, lse and the segment ids,
    which get no gradient. Under ``torch.inference_mode()`` the forward still
    launches the kernel once and saves nothing.

    ``FlashAttentionFunction.apply(q, k, v, segment_ids, causal, sm_scale,
    sliding_window, logit_softcap)`` returns out [B, Sq, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale, sliding_window, logit_softcap):
        options = dict(causal=causal, sm_scale=sm_scale, sliding_window=sliding_window,
                       logit_softcap=logit_softcap)
        out, lse = flash_fwd(q, k, v, segment_ids=segment_ids, **options)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.options = options
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, d_out, segment_ids=segment_ids,
                               **ctx.options)
        return dq, dk, dv, None, None, None, None, None
