"""Delayed-scaling fp8 training: fp8 products with amax-history scales.

Counterpart of ``accelerate_tpu/ops/quant.py``, TransformerEngine's
DelayedScaling recipe on the same arithmetic:

* :func:`fp8_matmul` quantizes ``x`` and the kernel with the *current*
  scales (``q = clip(x / scale)`` in the format's range, :func:`_quantize`),
  multiplies the fp8 operands with an f32 accumulator and rescales; its
  backward quantizes ``dy`` with the gradient scale (e5m2 under "HYBRID")
  and forms ``dx`` and ``dW`` on fp8 operands too. The current step's
  amaxes only feed the scales of later steps.
* The six statistics (three scales, three amax histories) are f32 buffers
  of :class:`Fp8Dense`, named as the JAX leaves, so ``state_dict``,
  ``utils/convert.py`` and checkpoints carry them, and no optimizer sees
  them. The JAX package threads their next values out of the backward as
  the meta "gradients" and an optax partition overwrites the leaves with
  them at the update. Here the backward records the amaxes of x, the
  kernel and dy in the module's ``amax_pending`` buffer (the max over every
  backward since the last commit), and :func:`commit_fp8_meta` rolls each
  history once and recomputes each scale (:func:`next_fp8_meta`, the JAX
  ``_bwd``'s arithmetic) at the optimizer update: the step post hook
  :func:`wrap_optimizer_for_fp8` registers, which ``Accelerator`` adds for a
  model with statistics. A skipped update (fp16, a non-finite gradient)
  drops them (:func:`discard_fp8_pending`). Across processes the pending
  amaxes of the whole model are max-reduced in one all-reduce at the
  commit, over the processes that hold the same statistics
  (:func:`statistics_group`: every axis of the mesh but ``pp``), so every
  process commits the amax of the whole logical tensor, as the JAX
  package's global arrays give: under ``tp`` the max over a split kernel's
  halves, a row-parallel input's and a column-parallel gradient's. Under
  ``pp`` each stage holds its own layers' ``[L / pp]`` slices of a stacked
  statistic (``parallel/sharding.py``) and commits them alone.

The fp8 product is a plain matmul in JAX (``lax.dot_general`` on fp8
arrays, outside any Pallas kernel); on the card it is
``torch._scaled_mm``, cuBLASLt's fp8 GEMM on the fp8 operands with the two
scales as its dequantization factors (:func:`fp8_gemm`), without fast
accumulation. sm_90 has no e5m2 x e5m2 product, so an "E5M2" recipe's
products take the widened route on the card: the fp8 values upcast to f32
(exact, also under TF32) and multiplied with an f32 accumulator. That
widened product is also the plain version a CPU tensor takes. A
``_scaled_mm`` that fails raises; nothing falls back.

``FP8RecipeKwargs`` (``utils/dataclasses.py``) configures margin, history
length, amax algorithm and formats (:func:`recipe_to_config_kwargs`);
``Accelerator(mixed_precision="fp8")`` is the bf16 policy, and the model's
``use_fp8`` swaps its projections for :class:`Fp8Dense`.
"""

from __future__ import annotations

import torch
from torch import nn

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

#: The formats of each ``fp8_format``: (forward operands, the gradient).
FP8_FORMATS = {"HYBRID": (E4M3, E5M2), "E4M3": (E4M3, E4M3), "E5M2": (E5M2, E5M2)}

#: Buffer names that carry fp8 statistics: kept f32 through every cast,
#: out of every optimizer, and off the clip.
FP8_META_NAMES = frozenset(
    {
        "input_scale",
        "kernel_scale",
        "grad_scale",
        "input_amax_history",
        "kernel_amax_history",
        "grad_amax_history",
    }
)

_META_SCALES = ("input_scale", "kernel_scale", "grad_scale")
_META_HISTS = ("input_amax_history", "kernel_amax_history", "grad_amax_history")
#: The non-persistent buffer of the amaxes a backward recorded, ``[..., 3]``
#: (input, kernel, grad); ``_EMPTY`` where none was recorded since the last
#: commit.
PENDING = "amax_pending"
_EMPTY = -1.0


def _amax(x) -> torch.Tensor:
    """max |x| as an f32 scalar (one read of x, no |x| written)."""
    return torch.linalg.vector_norm(x.detach(), float("inf")).float()


def _quantize(x, scale, dtype):
    """Quantize to fp8 with a divisor ``scale``: q ~ x / scale."""
    fp8_max = torch.finfo(dtype).max
    q = x.float() / torch.clamp(scale, min=1e-12)
    return torch.clamp(q, -fp8_max, fp8_max).to(dtype)


def _rolled(history, new_amax):
    """Push ``new_amax`` into slot 0 of the history ring (the last dim)."""
    out = torch.roll(history, 1, dims=-1)
    out[..., 0] = new_amax
    return out


def _next_scale(history, prev_scale, dtype, margin: int, algo: str):
    """Delayed-scaling update: the divisor that maps the history's amax to
    the format's max, with 2**margin headroom. A zero or non-finite amax
    keeps the old scale (TE semantics: no rescale until real data flows)."""
    amax = history.amax(dim=-1) if algo == "max" else history[..., 0]
    fp8_max = torch.finfo(dtype).max
    proposed = amax / fp8_max * (2.0 ** margin)
    ok = (amax > 0) & torch.isfinite(amax)
    return torch.where(ok, proposed, prev_scale).to(torch.float32)


# ---------------------------------------------------------------------------
# The fp8 product
# ---------------------------------------------------------------------------

def _col_major(t):
    """``t`` [K, N] with K contiguous (``_scaled_mm``'s second operand)."""
    return t if t.stride(0) == 1 and t.stride(1) == t.shape[0] else t.t().contiguous().t()


def _aligned(scale):
    """A scale cuBLASLt takes: 0-dim, at a 16-byte aligned address (a layer's
    slice of a stacked ``[L]`` scale is not, past layer 0)."""
    scale = scale.reshape(())
    return scale if scale.data_ptr() % 16 == 0 else scale.clone()


def _widened(a, b, scale, out_dtype):
    """The plain version: ``a @ b`` of fp8 operands upcast to f32 (every
    product exact), f32 accumulation, times ``scale``, in ``out_dtype``."""
    with torch.autocast(device_type=a.device.type, enabled=False):
        return (torch.matmul(a.float(), b.float()) * scale).to(out_dtype)


def fp8_gemm(a, b, scale_a, scale_b, out_dtype):
    """``(a @ b) * scale_a * scale_b`` in ``out_dtype``: ``a`` [M, K] and
    ``b`` [K, N] fp8 (any strides), the scales f32 scalars.

    A CUDA tensor runs ``torch._scaled_mm`` (``use_fast_accum=False``;
    ``a`` row-major and ``b`` column-major, copied where they are not; K
    and N multiples of 16, refused otherwise), or, for two e5m2 operands,
    which sm_90 cannot multiply, the widened product; a CPU tensor the
    widened product. ``fp8_gemm.launches`` counts the card's products,
    ``scaled_mm_launches`` and ``widened_launches`` each route's."""
    if a.device.type != "cuda":
        return _widened(a, b, scale_a * scale_b, out_dtype)
    fp8_gemm.launches += 1
    if a.dtype == E5M2 and b.dtype == E5M2:
        fp8_gemm.widened_launches += 1
        return _widened(a, b, scale_a * scale_b, out_dtype)
    (M, K), N = a.shape, b.shape[1]
    if K % 16 or N % 16:
        raise ValueError(f"torch._scaled_mm needs K and N multiples of 16; got [{M}, {K}] @ "
                         f"[{K}, {N}] (the fp8 path pads nothing)")
    out = torch._scaled_mm(a.contiguous(), _col_major(b), scale_a=_aligned(scale_a),
                           scale_b=_aligned(scale_b), out_dtype=out_dtype,
                           use_fast_accum=False)
    fp8_gemm.scaled_mm_launches += 1
    return out[0] if isinstance(out, tuple) else out


fp8_gemm.launches = 0
fp8_gemm.scaled_mm_launches = 0
fp8_gemm.widened_launches = 0


class _Fp8Matmul(torch.autograd.Function):
    """``x @ kernel`` on fp8 operands: the JAX ``custom_vjp``'s ``_fwd`` and
    ``_bwd`` for the product; the statistics' next values are left to
    :func:`next_fp8_meta` from the amaxes recorded in ``pending``."""

    @staticmethod
    def forward(ctx, x, kernel, input_scale, kernel_scale, grad_scale, pending, fwd_dtype,
                bwd_dtype, kept, out_dtype):
        x2 = x.reshape(-1, x.shape[-1])
        qx = _quantize(x2, input_scale, fwd_dtype)
        qk = _quantize(kernel, kernel_scale, fwd_dtype)

        def product():
            return fp8_gemm(qx, qk, input_scale, kernel_scale, out_dtype or x.dtype)

        y = product() if kept is None else kept.product(product)
        ctx.save_for_backward(qx, qk, input_scale, kernel_scale, grad_scale)
        ctx.meta = (x.shape, x.dtype, kernel.dtype, bwd_dtype, pending)
        ctx.amaxes = (_amax(x), _amax(kernel)) if pending is not None else None
        return y.reshape(*x.shape[:-1], kernel.shape[1])

    @staticmethod
    def backward(ctx, dy):
        qx, qk, input_scale, kernel_scale, grad_scale = ctx.saved_tensors
        x_shape, x_dtype, k_dtype, bwd_dtype, pending = ctx.meta
        dy2 = dy.reshape(-1, dy.shape[-1])
        qdy = _quantize(dy2, grad_scale, bwd_dtype)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = fp8_gemm(qdy, qk.t(), grad_scale, kernel_scale, x_dtype).reshape(x_shape)
        if ctx.needs_input_grad[1]:
            dk = fp8_gemm(qx.t(), qdy, input_scale, grad_scale, k_dtype)
        if pending is not None:
            with torch.no_grad():
                seen = torch.stack([*ctx.amaxes, _amax(dy)])
                pending.copy_(torch.maximum(pending, seen))
        return dx, dk, None, None, None, None, None, None, None, None


def fp8_matmul(x, kernel, meta: dict, *, fwd_dtype=E4M3, bwd_dtype=E5M2, margin: int = 0,
               amax_compute_algo: str = "max", out_dtype=None, _kept=None):
    """``x @ kernel`` (``kernel`` [in, out], the flax layout) on fp8
    operands with delayed scaling.

    ``meta`` holds the six statistics of :data:`FP8_META_NAMES`, and
    optionally ``amax_pending`` (``[3]`` f32, :data:`PENDING`), into which
    the backward max-accumulates the amaxes of x, the kernel and dy (JAX
    returns their next values as the meta cotangents instead;
    :func:`next_fp8_meta` computes those). ``margin`` and
    ``amax_compute_algo`` are taken where the JAX function takes them: they
    shape the next statistics, not this product. ``out_dtype`` (default
    ``x``'s): the dtype the scaled product leaves the GEMM in, f32 for a
    partial that is summed before its one cast (a row-parallel
    projection's)."""
    del margin, amax_compute_algo
    # Without a backward to come, no amax is recorded (nor computed).
    pending = meta.get(PENDING) if torch.is_grad_enabled() else None
    return _Fp8Matmul.apply(x, kernel, meta["input_scale"], meta["kernel_scale"],
                            meta["grad_scale"], pending, fwd_dtype, bwd_dtype, _kept, out_dtype)


def next_fp8_meta(meta: dict, pending, *, fwd_dtype=E4M3, bwd_dtype=E5M2, margin: int = 0,
                  amax_compute_algo: str = "max") -> dict:
    """The statistics after one update from the amaxes ``pending``
    (``[..., 3]``: input, kernel, grad; a leading layer dim for a stacked
    layer): each history rolled with its amax in slot 0 and each scale
    recomputed from it, exactly as the JAX ``_bwd`` computes its meta
    cotangents. Where an amax was not recorded (``_EMPTY``) the two
    statistics stay as they are."""
    out = {}
    for i, (hist, scale, dtype) in enumerate(zip(_META_HISTS, _META_SCALES,
                                                 (fwd_dtype, fwd_dtype, bwd_dtype))):
        amax = pending[..., i]
        seen = (amax >= 0) | torch.isnan(amax)
        new_hist = _rolled(meta[hist], amax)
        new_scale = _next_scale(new_hist, meta[scale], dtype, margin, amax_compute_algo)
        out[hist] = torch.where(seen[..., None], new_hist, meta[hist])
        out[scale] = torch.where(seen, new_scale, meta[scale])
    return out


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

class Fp8Dense(nn.Linear):
    """``nn.Linear`` whose product runs in fp8 (:func:`fp8_matmul`), the
    counterpart of the JAX ``Fp8Dense`` (TransformerEngine's ``te.Linear``).
    The weight is ``[features, in_features]`` in ``param_dtype``; the six
    statistics are f32 buffers beside it (scales 1, histories 0, ``[..]``
    of ``amax_history_len``), and ``amax_pending`` (not saved) holds the
    amaxes recorded since the last commit. ``dtype``: the compute dtype the
    input is cast to (None keeps the input's). A cast of the module
    (``.to(torch.bfloat16)``, ``.half()``) leaves the statistics f32."""

    # The JAX module's field defaults.
    param_dtype = torch.float32
    fwd_dtype = E4M3
    bwd_dtype = E5M2

    def __init__(self, in_features: int, features: int, use_bias: bool = False, dtype=None,
                 param_dtype=torch.float32, device=None, margin: int = 0,
                 amax_history_len: int = 16, amax_compute_algo: str = "max",
                 fwd_dtype=E4M3, bwd_dtype=E5M2):
        super().__init__(in_features, features, bias=use_bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype
        self.param_dtype = param_dtype
        self.margin = margin
        self.amax_history_len = amax_history_len
        self.amax_compute_algo = amax_compute_algo
        self.fwd_dtype = fwd_dtype
        self.bwd_dtype = bwd_dtype
        for name in _META_SCALES:
            self.register_buffer(name, torch.ones((), device=device, dtype=torch.float32))
        for name in _META_HISTS:
            self.register_buffer(name, torch.zeros((amax_history_len,), device=device,
                                                   dtype=torch.float32))
        self.register_buffer(PENDING, torch.full((3,), _EMPTY, device=device,
                                                 dtype=torch.float32), persistent=False)

    def _apply(self, fn, recurse=True):
        stats = {name: self._buffers[name] for name in (*FP8_META_NAMES, PENDING)}
        super()._apply(fn, recurse)
        for name, before in stats.items():
            after = self._buffers[name]
            if after is not None and after.dtype != torch.float32:
                self._buffers[name] = before.to(device=after.device)
        return self

    def meta(self) -> dict:
        """The six statistics and the pending amaxes, by name."""
        return {name: getattr(self, name) for name in (*_META_SCALES, *_META_HISTS, PENDING)}

    def recipe(self) -> dict:
        return {"fwd_dtype": self.fwd_dtype, "bwd_dtype": self.bwd_dtype, "margin": self.margin,
                "amax_compute_algo": self.amax_compute_algo}

    def _fp8_product(self, x, kept=None, out_dtype=None):
        """The fp8 product without the bias."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return fp8_matmul(x, self.weight.t(), self.meta(), **self.recipe(), out_dtype=out_dtype,
                          _kept=kept)

    def _fp8_forward(self, x, kept=None):
        y = self._fp8_product(x, kept)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def forward(self, x):
        return self._fp8_forward(x)


# ---------------------------------------------------------------------------
# Committing the statistics, and the optimizer
# ---------------------------------------------------------------------------

def fp8_modules(model) -> list:
    """The :class:`Fp8Dense` modules of ``model`` (a module, or a prepared
    model), in ``named_modules`` order."""
    module = getattr(model, "module", model)
    return [m for m in module.modules() if isinstance(m, Fp8Dense)]


def discard_fp8_pending(model):
    """Drop the amaxes recorded since the last commit (a skipped update)."""
    with torch.no_grad():
        for m in fp8_modules(model):
            getattr(m, PENDING).fill_(_EMPTY)


#: The mesh axes whose processes hold the same statistics: all but ``pp``,
#: whose stages each hold their own layers'.
STATISTICS_AXES = ("dp", "fsdp", "ep", "cp", "tp")


def statistics_group(mesh=None):
    """The :class:`~accelerate_tpu_torch.parallel.mesh.AxisGroup` of the
    processes that hold the same statistics as this one: on ``mesh``
    (default ``current_mesh()``) those that differ from it along
    :data:`STATISTICS_AXES` only, the processes of its pipeline stage;
    without a mesh, every process of the group."""
    from ..parallel.mesh import AxisGroup, _world
    from ..state import current_mesh

    mesh = current_mesh(mesh)
    if mesh is not None and mesh.coords is not None:
        return mesh.group(*STATISTICS_AXES)
    world, rank = _world()
    return AxisGroup((), list(range(world)), rank)


def commit_fp8_meta(model):
    """Apply the recorded amaxes of every :class:`Fp8Dense` of ``model``:
    in a process group, max-reduced first over the processes that hold the
    same statistics (:func:`statistics_group`; one all-reduce of one
    stacked vector); then each history rolled and each scale recomputed
    (:func:`next_fp8_meta`), in place, and the pending amaxes cleared."""
    from ..utils.operations import _group, _to_comm

    modules = fp8_modules(model)
    if not modules:
        return
    with torch.no_grad():
        pending = [getattr(m, PENDING) for m in modules]
        state = _group()
        group = statistics_group() if state is not None else None
        if group is not None and group.size > 1:
            flat = torch.cat([p.reshape(-1) for p in pending])
            comm, home = _to_comm(flat, state)
            flat = group.all_reduce(comm, op="max").to(home)
            offset = 0
            for p in pending:
                p.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
        for m, p in zip(modules, pending):
            for name, value in next_fp8_meta(m.meta(), p, **m.recipe()).items():
                getattr(m, name).copy_(value)
            p.fill_(_EMPTY)


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def fp8_meta_mask(params) -> dict:
    """``{name: bool}`` over a module's state dict (or a state dict): True
    on the fp8 statistics (by leaf name)."""
    module = getattr(params, "module", params)
    names = module.state_dict().keys() if isinstance(module, nn.Module) else params.keys()
    return {name: _leaf_name(name) in FP8_META_NAMES for name in names}


def has_fp8_meta(params) -> bool:
    return any(fp8_meta_mask(params).values())


def recipe_to_config_kwargs(recipe) -> dict:
    """An ``FP8RecipeKwargs`` as model-config fields
    (``LlamaConfig(**recipe_to_config_kwargs(recipe))``)."""
    return {
        "use_fp8": True,
        "fp8_margin": recipe.margin,
        "fp8_amax_history_len": recipe.amax_history_len,
        "fp8_amax_compute_algo": recipe.amax_compute_algo,
        "fp8_format": recipe.fp8_format,
    }


def wrap_optimizer_for_fp8(optimizer: torch.optim.Optimizer, model):
    """Make ``optimizer``'s every ``step()`` commit ``model``'s fp8
    statistics (:func:`commit_fp8_meta`, a step post hook); the optimizer is
    returned, as it is without statistics. The statistics are buffers, so
    the optimizer never steps them; one handed to it as a parameter is
    refused. ``optimizer._fp8_models`` lists the models it commits."""
    if not has_fp8_meta(model):
        return optimizer
    stats = {id(t) for m in fp8_modules(model) for t in m.meta().values()}
    if any(id(p) in stats for group in optimizer.param_groups for p in group["params"]):
        raise ValueError("an fp8 statistic is among the optimizer's parameters; the statistics "
                         "are overwritten at each update, never stepped")
    models = optimizer.__dict__.setdefault("_fp8_models", [])
    if not any(m is model for m in models):
        models.append(model)
        optimizer.register_step_post_hook(lambda opt, args, kwargs: commit_fp8_meta(model))
    return optimizer


def fp8_models_of(optimizer) -> list:
    """The models whose statistics ``optimizer``'s steps commit."""
    return list(getattr(optimizer, "_fp8_models", ()))

