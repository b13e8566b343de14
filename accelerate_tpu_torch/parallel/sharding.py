"""Activation-checkpointing policies, and the training state laid out
over the mesh: FSDP and ZeRO, tensor and pipeline splits.

Counterpart of ``accelerate_tpu/parallel/sharding.py``. The JAX package
declares a ``PartitionSpec`` for every leaf and leaves the collectives to
XLA; the port keeps the same policy, leaf for leaf, and runs the
collectives itself.

* The policy (``_spec_for_leaf`` ``:65``, :class:`ShardingRules` ``:104``,
  ``infer_param_shardings`` ``:148``, ``infer_opt_state_shardings``
  ``:208``, ``sharding_summary``, ``shard_params``): pure functions over
  ``(path, shape)`` pairs, paths in the JAX layout
  (:func:`reference_path`), that give each leaf a :class:`PartitionSpec`,
  which prints as JAX's does: ``pp`` on dim 0 of a stacked leaf (the
  layers), ``ep`` on dim 0 of a stacked expert leaf (``experts``), ``tp``
  by the Megatron rules, ``fsdp`` on the largest dimension left.
* The layout (:class:`ShardedLayout`): a prepared module's parameters
  stored as this process's chunk along each split dimension (its
  coordinate on each axis of the mesh, the elements a ``NamedSharding``
  gives the JAX package's device of this rank: an MoE layer keeps its
  ``E / ep`` experts resident). The ``fsdp`` chunks are
  gathered where they are used, through :class:`_GatherLeaves`, an
  autograd function whose forward all-gathers the compute-dtype chunks
  over the ``fsdp`` group and whose backward reduce-scatters the gradient
  (in f32) into the chunk's ``.grad`` (an expert leaf over ``fsdp`` only,
  never over ``ep``); the decoder layers gather one layer
  at a time inside their loop (``models/llama.py`` calls
  :meth:`ShardedLayout.gather_layer`), the other leaves once a forward
  (:meth:`ShardedLayout.compute_params`). The ``tp``, ``pp`` and ``ep``
  chunks stay split: the layers compute on them (``models/llama.py``,
  ``parallel/pipeline.py``, ``ops/moe.py``), and the leaves outside the layers (the
  embedding table, split on hidden, and ``lm_head``, on the vocabulary)
  are gathered whole for the forward (:class:`_GatherReplicated`). A
  pipeline stage also keeps only its layers' slices of the stacked fp8
  statistics (buffers), which the JAX stack rule splits with the weights.

A ``torch.nn.Linear`` weight is ``[out, in]`` where the JAX ``Dense``
kernel is ``[in, out]``: the layout decides on the reference's shape (the
last two dims swapped, :func:`reference_shape`) and maps the chosen
dimensions back (:func:`swap_spec`), so each process holds the same
elements as the JAX package's device of that rank.
"""

from __future__ import annotations

import enum
import logging
import re
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


class RematPolicy(enum.Enum):
    """What a checkpointed layer keeps for its backward."""

    # Only the layer's inputs: the backward recomputes the whole layer
    # (least activation memory; jax's nothing_saveable).
    NOTHING = "nothing"
    # Also the outputs of the products without batch dims, the projections;
    # the rest (norms, rotary, attention, activations) is recomputed
    # (jax's dots_with_no_batch_dims_saveable).
    DOTS = "dots"
    # All of it: nothing is recomputed (jax's everything_saveable; remat a
    # no-op, for debugging).
    EVERYTHING = "everything"


def resolve_remat_policy(name: str) -> RematPolicy:
    """The :class:`RematPolicy` of a remat-policy name; an unknown name
    raises ``ValueError``."""
    try:
        return RematPolicy(name)
    except ValueError:
        raise ValueError(f"unknown remat_policy {name!r}; expected "
                         f"{sorted(p.value for p in RematPolicy)}") from None


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """Per dimension, the mesh axis it is split over (or None), trailing
    Nones trimmed; prints as ``jax.sharding.PartitionSpec`` does."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec" + repr(tuple(self))

    __str__ = __repr__


class ShardingRules:
    """Ordered ``(regex, tp_dim)`` rules for tensor parallelism, matched
    against a leaf's '/'-joined path in the JAX package's layout
    (:func:`reference_path`): the Megatron layout.

    * q/k/v, gate and up projections: column parallel (the output dim);
    * the attention output and down projections: row parallel (the input
      dim);
    * ``embed``/``embedding``/``lm_head``: the last dim. On an embedding
      table ``[vocab, hidden]`` that is the hidden dim, on ``lm_head``'s
      kernel ``[hidden, vocab]`` the vocabulary; the JAX package's comment
      says "shard vocab" for both, its specs split hidden on the table;
    * norms, scales and biases: replicated."""

    DEFAULT_TP_RULES: list = [
        (r"(q_proj|k_proj|v_proj|qkv|query|key|value|wq|wk|wv)(/kernel|/w)?$", -1),
        (r"(gate_proj|up_proj|fc1|intermediate|w1|w3|mlp_in)(/kernel|/w)?$", -1),
        (r"(o_proj|out_proj|attn_out|dense_out|wo)(/kernel|/w)?$", -2),
        (r"(down_proj|fc2|w2|mlp_out)(/kernel|/w)?$", -2),
        (r"(embed|embedding|wte|word_embeddings|lm_head)(/kernel|/embedding|/w)?$", -1),
        (r"(norm|ln|layernorm|layer_norm|scale|bias)", None),
    ]

    def __init__(self, rules: Optional[list] = None, use_defaults: bool = True):
        self.rules = list(rules or [])
        if use_defaults:
            self.rules += self.DEFAULT_TP_RULES

    def tp_dim_for(self, path: str) -> Optional[int]:
        for pattern, dim in self.rules:
            if re.search(pattern, path, flags=re.IGNORECASE):
                return dim
        return None


# Parameter subtrees whose dim 0 is a stacked layout axis: pipeline stages
# (``[L, ...]`` leaves of ``PipelinedLlamaForCausalLM``) and MoE experts.
DEFAULT_STACK_RULES: list = [
    (r"(^|/)(blocks|stacked_layers|stages)(/|$)", "pp"),
    (r"(^|/)(experts|expert_)(/|$|\w)", "ep"),
]


def _spec_for_leaf(shape: tuple, fsdp_size: int, tp_size: int, tp_dim: Optional[int],
                   min_size_to_shard: int, prefer_last_dim_fsdp: bool = False,
                   stack_axis: Optional[str] = None, stack_axis_size: int = 1) -> PartitionSpec:
    """One leaf's spec. A stacked-layout axis claims dim 0 first, tp its
    ``tp_dim``; then ``fsdp`` takes the largest remaining dimension
    divisible by its size (the lowest index on ties, the highest with
    ``prefer_last_dim_fsdp``), for a leaf of at least
    ``min_size_to_shard`` elements."""
    ndim = len(shape)
    spec: list = [None] * ndim
    if stack_axis is not None and ndim > 0 and stack_axis_size > 1 \
            and shape[0] % stack_axis_size == 0:
        spec[0] = stack_axis
    if tp_size > 1 and tp_dim is not None and ndim > 0:
        d = tp_dim % ndim
        if spec[d] is None and shape[d] % tp_size == 0:
            spec[d] = "tp"
    if fsdp_size > 1 and int(np.prod(shape) if ndim else 1) >= min_size_to_shard:
        candidates = [d for d in range(ndim)
                      if spec[d] is None and shape[d] % fsdp_size == 0 and shape[d] >= fsdp_size]
        if candidates:
            order = sorted(candidates, key=lambda d: (shape[d], -d) if not prefer_last_dim_fsdp
                           else (shape[d], d))
            spec[order[-1]] = "fsdp"
    while spec and spec[-1] is None:
        spec.pop()
    return PartitionSpec(*spec)


def _pairs(leaves) -> list:
    """``(name, shape)`` pairs from a mapping of names to shapes or tensors,
    or from an iterable of such pairs."""
    items = leaves.items() if isinstance(leaves, Mapping) else leaves
    return [(name, tuple(getattr(x, "shape", x))) for name, x in items]


def _mesh_shape(mesh) -> dict:
    """Axis sizes: a :class:`~accelerate_tpu_torch.parallel.mesh.Mesh`'s,
    a mapping's as given (``{"fsdp": 2}``), else the process group as the
    one ``fsdp`` axis."""
    if mesh is not None:
        return dict(getattr(mesh, "shape", mesh))
    from ..state import PartialState

    return {"fsdp": PartialState().num_processes}


def infer_param_shardings(params, mesh=None, fsdp_plugin=None, tp_plugin=None, pp_plugin=None,
                          ep_plugin=None, extra_rules=None, stack_rules=None) -> dict:
    """``{name: PartitionSpec}`` for ``params`` (``(path, shape)`` pairs or
    a mapping to shapes or tensors; paths '/'-joined in the JAX layout, as
    :func:`reference_path` gives them) on ``mesh`` (a mesh or its axis
    sizes, default the process group as ``fsdp``), the JAX package's
    policy (reference ``:148-205``): with ``pp_plugin`` a leaf under
    ``blocks`` claims ``pp`` on dim 0, with ``ep_plugin`` a leaf under
    ``experts`` claims ``ep`` on dim 0 (where ``ep`` divides it); with
    ``tp_plugin`` and a ``tp`` axis
    above 1 the :class:`ShardingRules` (the plugin's ``rules``, then
    ``extra_rules``, then the defaults) claim ``tp``; then the FSDP policy
    of ``fsdp_plugin`` (``min_weight_size_to_shard``; ``NO_SHARD`` shards
    nothing) claims ``fsdp``."""
    sizes = _mesh_shape(mesh)
    fsdp_size = sizes.get("fsdp", 1)
    tp_size = sizes.get("tp", 1)
    pp_size = sizes.get("pp", 1) if pp_plugin is not None else 1
    ep_size = sizes.get("ep", 1) if ep_plugin is not None else 1
    min_size = getattr(fsdp_plugin, "min_weight_size_to_shard", 2**14) \
        if fsdp_plugin is not None else 2**62
    if fsdp_plugin is None or getattr(fsdp_plugin, "sharding_strategy", "FULL_SHARD") == "NO_SHARD":
        fsdp_size = 1
    rules = ShardingRules(rules=(getattr(tp_plugin, "rules", None) or []) + (extra_rules or []),
                          use_defaults=True) if (tp_plugin is not None and tp_size > 1) else None
    active_stack = [(pat, ax) for pat, ax in (stack_rules if stack_rules is not None
                                              else DEFAULT_STACK_RULES)
                    if {"pp": pp_size, "ep": ep_size}.get(ax, 1) > 1]
    out = {}
    for name, shape in _pairs(params):
        tp_dim = rules.tp_dim_for(name) if rules is not None else None
        stack_axis = next((ax for pat, ax in active_stack
                           if re.search(pat, name, flags=re.IGNORECASE)), None)
        out[name] = _spec_for_leaf(shape, fsdp_size, tp_size if rules is not None else 1, tp_dim,
                                   min_size, stack_axis=stack_axis,
                                   stack_axis_size={"pp": pp_size, "ep": ep_size}.get(stack_axis, 1))
    return out


def _path_key(name: str) -> tuple:
    return tuple(part for part in re.split(r"[/.]", name) if part)


def infer_opt_state_shardings(opt_state, mesh=None, params=None, param_shardings=None,
                              axis: Optional[str] = None,
                              min_size_to_shard: int = 2**11) -> dict:
    """``{name: PartitionSpec}`` for the optimizer-state leaves
    ``opt_state`` (``(name, shape)`` pairs, e.g. ``count``, ``mu/<param>``,
    ``nu/<param>``): ZeRO-1/2. A leaf whose name ends with a parameter's
    name and has its shape inherits that parameter's spec (the longest
    such suffix wins); then ``axis`` ("dp" when the mesh has a dp axis
    above 1, else "fsdp") claims the largest free dimension divisible by
    its size. Scalars, leaves under ``min_size_to_shard`` elements, and
    leaves with no divisible dimension keep the inherited spec. Logs the
    JAX package's one-line report with its four counts."""
    sizes = _mesh_shape(mesh)
    if axis is None:
        axis = "dp" if sizes.get("dp", 1) > 1 else "fsdp"
    axis_size = sizes.get(axis, 1)
    suffix_specs: dict = {}
    if params is not None and param_shardings is not None:
        pairs = _pairs(params)
        specs = (list(param_shardings.values()) if isinstance(param_shardings, Mapping)
                 else list(param_shardings))
        if len(pairs) == len(specs):
            for (name, shape), spec in zip(pairs, specs):
                suffix_specs[_path_key(name)] = (shape, tuple(spec))
    suffix_lens = sorted({len(k) for k in suffix_specs}, reverse=True)
    stats = {"sharded": 0, "inherited": 0, "small": 0, "indivisible": 0}
    fallbacks: list = []

    def trim(spec: list) -> PartitionSpec:
        out = list(spec)
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def leaf_spec(name, shape):
        ndim = len(shape)
        key = _path_key(name)
        base: list = [None] * ndim
        for k in suffix_lens:
            if k <= len(key):
                hit = suffix_specs.get(key[-k:])
                if hit is not None and hit[0] == shape:
                    for d, ax in enumerate(hit[1][:ndim]):
                        base[d] = ax
                    break
        size = int(np.prod(shape)) if ndim else 1
        if ndim == 0 or size < min_size_to_shard or axis_size <= 1:
            stats["small"] += 1
            return trim(base)
        claimed = {a for e in base if e is not None
                   for a in (e if isinstance(e, tuple) else (e,))}
        if axis in claimed:
            stats["inherited"] += 1
            return trim(base)
        candidates = [d for d in range(ndim)
                      if base[d] is None and shape[d] % axis_size == 0 and shape[d] >= axis_size]
        if not candidates:
            stats["indivisible"] += 1
            fallbacks.append(name)
            return trim(base)
        base[max(candidates, key=lambda d: (shape[d], -d))] = axis
        stats["sharded"] += 1
        return trim(base)

    out = {name: leaf_spec(name, shape) for name, shape in _pairs(opt_state)}
    logger.info(
        "opt-state zero sharding over %r (size %d): %d sharded, %d inherited, "
        "%d scalar/small replicated, %d non-divisible replicated%s",
        axis, axis_size, stats["sharded"], stats["inherited"], stats["small"],
        stats["indivisible"],
        (" (" + ", ".join(fallbacks[:4]) + (", ..." if len(fallbacks) > 4 else "") + ")")
        if fallbacks else "")
    return out


def sharding_summary(shardings) -> dict:
    """How many leaves have each spec, by its printed form."""
    counts: dict = {}
    for spec in (shardings.values() if isinstance(shardings, Mapping) else shardings):
        counts[str(spec)] = counts.get(str(spec), 0) + 1
    return counts


def _dim_of(spec, axis: str = "fsdp") -> Optional[int]:
    """The dimension ``spec`` splits over ``axis``, or None."""
    for d, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None


def chunk_of(tensor: torch.Tensor, dim: Optional[int], rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous chunk of ``tensor`` along ``dim`` (a
    view; the whole tensor for ``dim`` None)."""
    if dim is None:
        return tensor
    k = tensor.shape[dim] // world
    return tensor.narrow(dim, rank * k, k)


def shard_params(params: Mapping, shardings: Mapping, rank: Optional[int] = None,
                 world: Optional[int] = None) -> dict:
    """This process's chunk of every tensor of ``params`` by its spec in
    ``shardings`` (a contiguous copy; replicated leaves as they are).
    ``rank``/``world`` default to the process group's."""
    if rank is None or world is None:
        from ..state import PartialState

        state = PartialState()
        rank, world = state.process_index, state.num_processes
    return {name: chunk_of(t, _dim_of(shardings[name]), rank, world).contiguous()
            for name, t in params.items()}


# ---------------------------------------------------------------------------
# The layout of a prepared module
# ---------------------------------------------------------------------------

def _is_kernel(module: nn.Module, name: str, ndim: int) -> bool:
    """A ``torch.nn.Linear`` weight (of one layer, or stacked)."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    return leaf == "weight" and isinstance(owner, nn.Linear) and ndim >= 2


def reference_path(module: nn.Module, name: str) -> str:
    """The '/'-joined path of parameter ``name`` in the JAX package's tree,
    which the sharding rules match: ``layers.<i>`` is ``layers_<i>``, a
    ``torch.nn.Linear`` weight is a ``kernel`` and an ``nn.Embedding``'s
    an ``embedding`` (``model.layers.0.self_attn.q_proj.weight`` ->
    ``model/layers_0/self_attn/q_proj/kernel``)."""
    parts = name.split(".")
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if leaf == "weight" and isinstance(owner, nn.Linear):
        parts[-1] = "kernel"
    elif leaf == "weight" and isinstance(owner, nn.Embedding):
        parts[-1] = "embedding"
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return "/".join(out)


def reference_shape(module: nn.Module, name: str, shape: tuple) -> tuple:
    """``shape`` in the JAX package's layout: a ``torch.nn.Linear`` weight
    (``[..., out, in]``) is a ``Dense`` kernel ``[..., in, out]``."""
    if _is_kernel(module, name, len(shape)):
        return (*shape[:-2], shape[-1], shape[-2])
    return tuple(shape)


def spec_on(dim: Optional[int], axis: str = "fsdp") -> PartitionSpec:
    """The spec splitting dimension ``dim`` over ``axis`` (None: whole)."""
    return PartitionSpec(*([None] * dim + [axis])) if dim is not None else PartitionSpec()


def swap_spec(spec, ndim: int, kernel: bool) -> PartitionSpec:
    """``spec`` in the other layout (a kernel's last two dims swapped)."""
    axes = list(spec) + [None] * (ndim - len(spec))
    if kernel and ndim >= 2:
        axes[-2], axes[-1] = axes[-1], axes[-2]
    while axes and axes[-1] is None:
        axes.pop()
    return PartitionSpec(*axes)


def _largest_free(shape: tuple, spec) -> Optional[int]:
    """The largest dimension ``spec`` leaves free, the lowest on ties: the
    policy over an ``fsdp`` axis of size 1, which divides every one."""
    base = list(spec) + [None] * (len(shape) - len(spec))
    free = [d for d in range(len(shape)) if base[d] is None]
    return max(free, key=lambda d: (shape[d], -d)) if free else None


def _sizes(mesh) -> dict:
    """Axis sizes of ``mesh``: an int is a process group of that many as
    the one ``fsdp`` axis."""
    if isinstance(mesh, int):
        return {"fsdp": mesh}
    return _mesh_shape(mesh)


def _statistics(module: nn.Module) -> list:
    """``(name, buffer)`` of ``module``'s fp8 statistics and pending amaxes
    (``ops/quant.py``): the buffers a layout splits as it splits their
    layer's parameters."""
    from ..ops.quant import FP8_META_NAMES, PENDING

    return [(name, b) for name, b in module.named_buffers()
            if name.rsplit(".", 1)[-1] in (*FP8_META_NAMES, PENDING)]


def layout_specs(module: nn.Module, fsdp_plugin, mesh, tp_plugin=None, pp_plugin=None,
                 ep_plugin=None) -> dict:
    """``{name: PartitionSpec}`` of ``module``'s parameters, and of its fp8
    statistics (split over ``pp`` only, dim 0 of a stacked one), as the
    accelerator stores them, in the torch layout: the JAX policy
    (:func:`infer_param_shardings` on each leaf's :func:`reference_path` and
    :func:`reference_shape`) mapped back. ``mesh`` is a mesh, its axis
    sizes, or a number of processes (the one ``fsdp`` axis). An ``fsdp``
    axis of size 1 under an FSDP plugin still names a dimension (every
    dimension divides it), so the gathers and reduce-scatters run there
    too, as the identity."""
    sizes = _sizes(mesh)
    out = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        kernel = _is_kernel(module, name, len(shape))
        ref = reference_shape(module, name, shape)
        path = reference_path(module, name)
        spec = infer_param_shardings([(path, ref)], sizes, fsdp_plugin, tp_plugin, pp_plugin,
                                     ep_plugin)[path]
        if fsdp_plugin is not None and sizes.get("fsdp", 1) == 1 and shape \
                and fsdp_plugin.sharding_strategy != "NO_SHARD" \
                and int(np.prod(shape)) >= fsdp_plugin.min_weight_size_to_shard:
            dim = _largest_free(ref, spec)
            if dim is not None:
                axes = list(spec) + [None] * (len(ref) - len(spec))
                axes[dim] = "fsdp"
                spec = PartitionSpec(*axes)
        out[name] = swap_spec(spec, len(shape), kernel)
    for name, b in _statistics(module):
        # The JAX stack rule puts a stacked statistic on ``pp`` like its
        # layer's weights; its tp rules replicate it. Over fsdp it stays
        # whole too: every product reads its scales, and the commit writes
        # the values the JAX package's global array holds.
        path = reference_path(module, name)
        out[name] = infer_param_shardings([(path, tuple(b.shape))], sizes,
                                          pp_plugin=pp_plugin)[path]
    return out


def zero_specs(params: list, param_specs: list, mesh, min_size_to_shard: int) -> dict:
    """``{name: PartitionSpec}`` of each parameter's AdamW moments under
    ZeRO (``params``: ``(name, shape)`` pairs in the JAX layout,
    ``param_specs`` their specs; ``mesh`` as :func:`layout_specs` takes
    it): ``infer_opt_state_shardings`` over the ``count`` and ``mu``/``nu``
    leaves of optax's AdamW state. A zero axis of size 1 still names the
    largest free dimension of a replicated leaf, as :func:`layout_specs`
    does."""
    sizes = _sizes(mesh)
    axis = "dp" if sizes.get("dp", 1) > 1 else "fsdp"
    leaves = [("count", ())] + [(f"{m}/{name}", shape) for m in ("mu", "nu")
                                for name, shape in params]
    specs = infer_opt_state_shardings(leaves, sizes, params=params, param_shardings=param_specs,
                                      min_size_to_shard=min_size_to_shard)
    out = {}
    for (name, shape), spec in zip(params, param_specs):
        out[name] = specs[f"mu/{name}"]
        if sizes.get(axis, 1) == 1 and not any(spec) and shape \
                and int(np.prod(shape)) >= min_size_to_shard:
            out[name] = spec_on(_largest_free(shape, ()), axis)
    return out


def zero_axis(mesh) -> str:
    """The axis ZeRO shards the optimizer state over: ``dp`` when the mesh
    has a dp axis above 1, else ``fsdp``."""
    return "dp" if _sizes(mesh).get("dp", 1) > 1 else "fsdp"


class _GatherLeaves(torch.autograd.Function):
    """The whole leaves, in ``dtype``, from every process's chunks; the
    backward reduce-scatters each gradient in f32 back into the chunk's
    dtype, times ``scale``. One all-gather and one reduce-scatter for all
    the leaves of a call (their chunks flattened into one buffer)."""

    @staticmethod
    def forward(ctx, layout, dims, dtype, *chunks):
        ctx.layout, ctx.dims = layout, dims
        ctx.meta = [(c.shape, c.dtype) for c in chunks]
        return tuple(layout._all_gather([c.detach().to(dtype) for c in chunks], dims))

    @staticmethod
    def backward(ctx, *grads):
        layout = ctx.layout
        parts = [g if g is not None else torch.zeros((), device=layout.device).expand(
            layout._full_shape(shape, d)) for g, (shape, _), d in
            zip(grads, ctx.meta, ctx.dims)]
        reduced = layout._reduce_scatter(parts, ctx.dims)
        return (None, None, None, *(r.to(dt) for r, (_, dt) in zip(reduced, ctx.meta)))


class _SumGradient(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group``: a
    leaf or an input every process holds alike but each uses on its own
    share (Megatron's f before column-parallel projections; an MoE router
    over an ``ep`` process's routing groups)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


class _SliceReplicated(torch.autograd.Function):
    """This process's ``k``-wide chunk along ``dim`` of a tensor every
    process of ``group`` holds whole; the backward all-gathers the chunks'
    gradients, so every process holds the whole tensor's gradient."""

    @staticmethod
    def forward(ctx, t, group, dim, k):
        ctx.group, ctx.dim = group, dim
        return t.narrow(dim, group.index * k, k)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather(grad.contiguous(), ctx.dim), None, None, None


class _GatherSplit(torch.autograd.Function):
    """Every process's chunk along ``dim`` concatenated (an all-gather over
    ``group``); each process uses the whole differently, so the backward
    sums the gradients and keeps this process's chunk (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(t.contiguous(), dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad.contiguous(), ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    """A leaf split along ``dim`` over ``group``, whole: every process's
    chunk all-gathered. Whatever uses the whole leaf runs the same on every
    process of the group, so each holds the same gradient, and the backward
    keeps this process's chunk of it (no communication): the tensor-parallel
    embedding table and ``lm_head``, an MoE layer's outputs over ``ep``."""

    @staticmethod
    def forward(ctx, chunk, group, dim):
        ctx.group, ctx.dim, ctx.k = group, dim, chunk.shape[dim]
        return group.all_gather(chunk, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.group.index * ctx.k, ctx.k), None, None


class ShardedLayout:
    """Where a prepared module's parameters live across the mesh, and the
    collectives that put them together.

    ``specs`` (``layout_specs``) name each leaf's split dimensions:
    ``dims`` its ``fsdp`` one, ``splits`` every axis's (``{"tp": 0,
    "fsdp": 1}``). :meth:`shard` replaces each split parameter's data, in
    place, by this process's chunk along every split (the elements the JAX
    package's device of this rank holds), so an optimizer built on the
    parameters steps the chunks. The ``fsdp`` chunks are gathered where a
    layer runs (over the mesh's ``fsdp`` group); the ``tp`` and ``pp``
    chunks stay split, the layers computing on them (``models/llama.py``),
    except the leaves outside the decoder layers, which are gathered whole
    once a forward. ``gather_in_remat`` (``FULL_SHARD`` with activation
    checkpointing): a decoder layer's gather runs inside its checkpoint
    and again in the backward's recompute; otherwise the gathered weights
    are kept for the backward (one gather a layer a step).
    ``remat_policy``: the plugin's, for every layer, or None.
    ``grad_scale`` multiplies the reduce-scattered gradients (the
    accelerator sets it: 1 for a loss weighted by its label share, else 1
    / the data-parallel size). ``gathers`` counts layer gathers (both the
    forward's and the recompute's)."""

    def __init__(self, module: nn.Module, specs: Mapping, mesh, compute_dtype=torch.float32,
                 gather_in_remat: bool = False, remat_policy: Optional[str] = None,
                 reduce_dtype=torch.float32):
        self.specs = dict(specs)
        self.dims = {n: _dim_of(s) for n, s in self.specs.items()}
        self.splits = {n: {ax: d for d, ax in enumerate(s) if ax is not None}
                       for n, s in self.specs.items()}
        self.full_shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
        self.full_shapes.update((n, tuple(b.shape)) for n, b in module.named_buffers()
                                if n in self.specs)
        self.mesh = mesh
        self._fsdp = mesh.group("fsdp")
        self.rank, self.world = self._fsdp.index, self._fsdp.size
        self.compute_dtype = compute_dtype
        self.reduce_dtype = reduce_dtype
        self.gather_in_remat = gather_in_remat
        self.remat_policy = remat_policy
        self.layer_prefixes: tuple = ()
        self.grad_scale = 1.0
        self.gathers = 0
        self.device = next(module.parameters()).device

    def attach(self, module: nn.Module):
        """Hand the layout to every submodule that loops over decoder
        layers (a ``_layer_prefixes`` class attribute), with its own name
        prefix; their leaves are then gathered a layer at a time."""
        prefixes = []
        for name, sub in module.named_modules():
            if hasattr(type(sub), "_layer_prefixes"):
                prefix = f"{name}." if name else ""
                sub._sharded_layout = self
                sub._layout_prefix = prefix
                prefixes += [prefix + p for p in type(sub)._layer_prefixes]
        self.layer_prefixes = tuple(prefixes)
        module._sharded_layout = self

    # -- storage --------------------------------------------------------

    def sharded(self, name: str) -> bool:
        return self.dims.get(name) is not None

    def _group(self, axis: str):
        return self._fsdp if axis == "fsdp" else self.mesh.group(axis)

    def split_axes(self, name: str) -> frozenset:
        """The axes of more than one process that ``name`` is split over."""
        return frozenset(ax for ax in self.splits.get(name, {})
                         if self._group(ax).size > 1)

    def chunk(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """This process's chunk of the whole ``tensor`` of leaf ``name``."""
        for ax, d in self.splits.get(name, {}).items():
            group = self._group(ax)
            tensor = chunk_of(tensor, d, group.index, group.size)
        return tensor

    def shard(self, module: nn.Module):
        """Each split parameter's and statistic's data becomes this
        process's chunk (a contiguous copy; the tensor object stays, so
        optimizers keep it)."""
        with torch.no_grad():
            for name, t in _stored(module):
                if self.splits.get(name) and tuple(t.shape) == self.full_shapes[name]:
                    t.data = self.chunk(name, t.data).clone()

    def full_state_dict(self, module: nn.Module) -> dict:
        """Every parameter whole (gathered over each of its splits, no
        autograd) and the buffers, on this process's device: what an
        unsharded module's ``state_dict`` holds."""
        out = {}
        with torch.no_grad():
            for name, t in module.state_dict().items():
                for ax, d in sorted(self.splits.get(name, {}).items(),
                                    key=lambda item: item[0] != "fsdp"):
                    if ax == "fsdp":
                        t = self._all_gather([t], (d,))[0]
                    else:
                        t = self._group(ax).all_gather(t, d)
                out[name] = t
        return out

    def load_full(self, module: nn.Module, state_dict: Mapping):
        """Copy whole tensors into the module, each parameter's and
        statistic's chunk where it is split."""
        stored = dict(_stored(module))
        with torch.no_grad():
            for name, value in state_dict.items():
                stored[name].copy_(self.chunk(name, torch.as_tensor(value)))

    # -- the collectives --------------------------------------------------

    def _full_shape(self, shape, dim):
        full = list(shape)
        full[dim] *= self.world
        return tuple(full)

    def _all_gather(self, chunks: list, dims) -> list:
        if self.world == 1:
            return list(chunks)
        flat = torch.cat([c.reshape(-1) for c in chunks])
        out = self._fsdp.all_gather(flat).view(self.world, -1)
        wholes, offset = [], 0
        for c, d in zip(chunks, dims):
            part = out[:, offset:offset + c.numel()].reshape(self.world, *c.shape)
            wholes.append(torch.cat(part.unbind(0), dim=d))
            offset += c.numel()
        return wholes

    def _reduce_scatter(self, wholes: list, dims) -> list:
        if self.world == 1:
            return [g.to(self.reduce_dtype) * self.grad_scale if self.grad_scale != 1.0
                    else g.to(self.reduce_dtype) for g in wholes]
        rows = [torch.stack(g.to(self.reduce_dtype).chunk(self.world, dim=d))
                .reshape(self.world, -1) for g, d in zip(wholes, dims)]
        mine = self._fsdp.reduce_scatter(torch.cat(rows, dim=1).reshape(-1))
        if self.grad_scale != 1.0:
            mine.mul_(self.grad_scale)
        out, offset = [], 0
        for g, d in zip(wholes, dims):
            shape = list(g.shape)
            shape[d] //= self.world
            n = int(np.prod(shape))
            out.append(mine[offset:offset + n].view(shape))
            offset += n
        return out

    def _gather(self, tensors: list, dims: list) -> list:
        """The whole leaves of ``tensors`` (chunks along ``dims``) in the
        compute dtype, through :class:`_GatherLeaves`."""
        return list(_GatherLeaves.apply(self, tuple(dims), self.compute_dtype, *tensors))

    # -- what a forward uses --------------------------------------------------

    def _in_layers(self, name: str) -> bool:
        return any(name.startswith(p) for p in self.layer_prefixes)

    def compute_params(self, module: nn.Module) -> dict:
        """The tensors a forward through ``functional_call`` takes, by name:
        each leaf outside the decoder layers whole in the compute dtype
        (the ``fsdp`` chunks gathered in one collective, then the ``tp``
        chunks, :class:`_GatherReplicated`); the layers' leaves as stored
        (f32 chunks), which :meth:`gather_layer` puts together inside the
        layer loop."""
        params = list(module.named_parameters())
        gathered = [(n, p) for n, p in params if self.sharded(n) and not self._in_layers(n)]
        out = dict(zip((n for n, _ in gathered), self._gather(
            [p for _, p in gathered], [self.dims[n] for n, _ in gathered]))) if gathered else {}
        for n, p in params:
            if n not in out:
                out[n] = p if self._in_layers(n) or not p.is_floating_point() \
                    else p.to(self.compute_dtype)
            if not self._in_layers(n):
                for ax, d in self.splits.get(n, {}).items():
                    if ax != "fsdp" and self._group(ax).size > 1:
                        out[n] = _GatherReplicated.apply(out[n], self._group(ax), d)
        return {n: out[n] for n, _ in params}

    def gather_layer(self, prefix: str, params: Mapping, stacked: bool = False) -> dict:
        """One decoder layer's parameters (module-relative names under
        ``prefix``), their ``fsdp`` chunks put together and in the compute
        dtype: the sharded ones all-gathered in one collective (counted in
        :attr:`gathers`), the others cast. ``stacked``: ``params`` are one
        layer's slices of ``[num_layers, ...]`` leaves, so a leaf's shard
        dimension is one less (a leaf split over the layer axis is put
        together beforehand, :meth:`gather_stacked`)."""
        names, tensors, dims = [], [], []
        out = {}
        for rel, t in params.items():
            dim = self.dims.get(prefix + rel)
            if dim is not None and stacked:
                dim = dim - 1 if dim > 0 else None
            if dim is not None:
                names.append(rel)
                tensors.append(t)
                dims.append(dim)
            else:
                out[rel] = t.to(self.compute_dtype) if t.is_floating_point() else t
        if names:
            self.gathers += 1
            out.update(zip(names, self._gather(tensors, dims)))
        return {rel: out[rel] for rel in params}

    def gather_stacked(self, prefix: str, stacked: Mapping) -> dict:
        """``[num_layers, ...]`` leaves under ``prefix``: those split over
        the layer axis (dim 0) by ``fsdp`` gathered whole now, the rest as
        they are."""
        out = dict(stacked)
        names = [rel for rel in stacked if self.dims.get(prefix + rel) == 0]
        if names:
            wholes = self._gather([stacked[r] for r in names], [0] * len(names))
            out.update(zip(names, wholes))
        return out


def _stored(module: nn.Module) -> list:
    """``(name, tensor)`` of every parameter and buffer of ``module``."""
    return [*module.named_parameters(), *module.named_buffers()]


def sharded_layout_of(module: nn.Module) -> Optional[ShardedLayout]:
    """The :class:`ShardedLayout` a prepared module's parameters follow,
    or None."""
    return getattr(module, "_sharded_layout", None)
