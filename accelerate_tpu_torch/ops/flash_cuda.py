"""Flash-attention forward on Hopper: the wrapper of ``csrc/flash_fwd.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``accelerate_tpu/ops/flash_pallas.py::_fwd_kernel``
(launched by ``_flash_fwd``; public entry ``pallas_flash_attention``). It
computes the same function: tiled online-softmax attention in f32 with
causal, sliding-window (banded: only the key tiles of the band are visited),
segment-id and Gemma2 softcap masks, an ``sm_scale`` override and GQA by
index, returning ``(out, lse)``. The TPU kernel broadcast lse over 128
lanes; here it is stored once per row, ``[B, H, Sq]`` f32.

What bounds it: at the main-path shape (Llama-3-8B widths, B=4, S=2048,
causal, bf16) a call does ~137 GFLOP over ~169 MB moved, so the tensor-core
rate bounds it. The kernel keeps the score and probability tiles in
registers and feeds both products to the tensor cores (``mma.sync``); see
the source's header for what it leaves for later.

For a CUDA tensor :func:`flash_fwd` launches the kernel or raises. Only a
tensor on the CPU takes :func:`flash_fwd_reference`, the plain version.
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


def flash_fwd_reference(q, k, v, causal: bool = True, sm_scale=None, sliding_window=None,
                        segment_ids=None, logit_softcap=None):
    """Plain version of :func:`flash_fwd`: dense masked softmax in f32.

    Same arguments and results: q [B, Sq, H, D], k/v [B, Sk, G, D] with
    ``H = G * rep``; returns ``(out [B, Sq, H, D] in q's dtype, lse [B, H,
    Sq] f32)``. Masked logits take the finite ``NEG_INF`` and an empty row
    divides by 1, as the kernel does."""
    _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap)
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    rep = H // G
    scale = D ** -0.5 if sm_scale is None else sm_scale
    qf = q.float().reshape(B, Sq, G, rep, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if causal or sliding_window is not None or segment_ids is not None:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if sliding_window is not None:
            mask = mask & (k_pos > q_pos - sliding_window)
        if segment_ids is not None:
            mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p, v.float()) / l
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return out, lse


def _library():
    from ._build import load

    lib = load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [f32, f32, i32, i32, ptr]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_fwd(q, k, v, causal: bool = True, sm_scale=None, sliding_window=None,
              segment_ids=None, logit_softcap=None):
    """Flash-attention forward: ``(out, lse)``.

    q [B, Sq, H, D]; k/v [B, Sk, G, D] with ``H = G * rep`` (query head h
    reads kv head ``h // rep``); ``segment_ids`` [B, S] masks pairs from
    different segments; ``sliding_window=w`` keeps keys in ``(q - w, q]``
    and needs ``causal``; ``logit_softcap`` bounds logits by ``cap *
    tanh(s / cap)`` before the mask. Returns out [B, Sq, H, D] in q's dtype
    and lse [B, H, Sq] f32.

    A CUDA tensor launches the Hopper kernel (float32, bfloat16 or float16;
    ``D % 16 == 0`` and ``D <= 256``) or raises; a CPU tensor takes
    :func:`flash_fwd_reference`. ``flash_fwd.launches`` counts the kernel's
    launches."""
    _check_args(q, k, v, causal, sliding_window, segment_ids, logit_softcap)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                   sliding_window=sliding_window, segment_ids=segment_ids,
                                   logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q.device}")
    tensors = [q, k, v] + ([segment_ids] if segment_ids is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and segment_ids must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32/bfloat16/float16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if D % 16 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd needs head_dim % 16 == 0 and <= {MAX_HEAD_DIM}, got {D}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd needs 16-byte aligned q, k, v")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, G, Sq, Sk, D,
            float(sm_scale), float(logit_softcap or 0.0), int(bool(causal)),
            int(sliding_window or 0), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0
