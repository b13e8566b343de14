"""Activation-checkpointing policies, and the training state sharded over
the process group: FSDP and ZeRO.

Counterpart of ``accelerate_tpu/parallel/sharding.py``. The JAX package
declares a ``PartitionSpec`` for every leaf and leaves the collectives to
XLA; the port keeps the same policy, leaf for leaf, and runs the
collectives itself.

* The policy (``_spec_for_leaf`` ``:65``, ``infer_param_shardings``
  ``:148``, ``infer_opt_state_shardings`` ``:208``, ``sharding_summary``,
  ``shard_params``): pure functions over ``(name, shape)`` pairs that give
  each leaf a :class:`PartitionSpec`, which prints as JAX's does. The
  process group is the one mesh axis, ``fsdp``; the tp/pp/ep rules need a
  mesh (ROADMAP.md, A8d) and raise.
* The layout (:class:`ShardedLayout`): a prepared module's parameters
  stored as this process's contiguous chunk along each sharded leaf's
  dimension (the order of a ``NamedSharding`` over a 1-D mesh), and the
  gathers that put a leaf back together where it is used. A gather runs
  through :class:`_GatherLeaves`, an autograd function whose forward
  all-gathers the compute-dtype chunks and whose backward reduce-scatters
  the gradient (in f32) into the chunk's ``.grad``. The decoder layers
  gather one layer at a time inside their loop (``models/llama.py`` calls
  :meth:`ShardedLayout.gather_layer`); the other leaves are gathered once a
  forward (:meth:`ShardedLayout.compute_params`).

A ``torch.nn.Linear`` weight is ``[out, in]`` where the JAX ``Dense``
kernel is ``[in, out]``: the layout decides on the reference's shape (the
last two dims swapped, :func:`reference_shape`) and maps the chosen
dimension back, so each process holds the same elements as the JAX
package's device of that rank.
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


def _later(what: str):
    return NotImplementedError(f"{what} is not ported to accelerate_tpu_torch yet "
                               "(ROADMAP.md, A8d)")


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
    """Axis sizes: ``mesh`` as given (``{"fsdp": 2}``), else the process
    group as the one ``fsdp`` axis."""
    if mesh is not None:
        return dict(mesh)
    from ..state import PartialState

    return {"fsdp": PartialState().num_processes}


def infer_param_shardings(params, mesh=None, fsdp_plugin=None, tp_plugin=None, pp_plugin=None,
                          ep_plugin=None, extra_rules=None, stack_rules=None) -> dict:
    """``{name: PartitionSpec}`` for ``params`` (``(name, shape)`` pairs or
    a mapping to shapes or tensors) on ``mesh`` (axis sizes, default the
    process group as ``fsdp``): the FSDP policy of ``fsdp_plugin``
    (``min_weight_size_to_shard``, ``NO_SHARD`` shards nothing), nothing
    without one. Tensor, pipeline and expert parallelism need a mesh of
    several axes (ROADMAP.md, A8d) and raise; ``stack_rules`` only act with
    them."""
    if tp_plugin is not None or pp_plugin is not None or ep_plugin is not None or extra_rules:
        raise _later("tensor, pipeline and expert parallelism (tp/pp/ep sharding rules)")
    sizes = _mesh_shape(mesh)
    if set(sizes) - {"fsdp", "dp"} and any(v > 1 for k, v in sizes.items()
                                           if k not in ("fsdp", "dp")):
        raise _later(f"a mesh of axes {sorted(sizes)}")
    if fsdp_plugin is None or getattr(fsdp_plugin, "sharding_strategy", "FULL_SHARD") == "NO_SHARD":
        fsdp_size = 1
    else:
        fsdp_size = sizes.get("fsdp", 1)
    min_size = getattr(fsdp_plugin, "min_weight_size_to_shard", 2**14) \
        if fsdp_plugin is not None else 2**62
    return {name: _spec_for_leaf(shape, fsdp_size, 1, None, min_size)
            for name, shape in _pairs(params)}


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


def reference_shape(module: nn.Module, name: str, shape: tuple) -> tuple:
    """``shape`` in the JAX package's layout: a ``torch.nn.Linear`` weight
    (``[..., out, in]``) is a ``Dense`` kernel ``[..., in, out]``."""
    if _is_kernel(module, name, len(shape)):
        return (*shape[:-2], shape[-1], shape[-2])
    return tuple(shape)


def swap_dim(dim: Optional[int], ndim: int, kernel: bool) -> Optional[int]:
    """``dim`` of a leaf in the other layout: a kernel's last two dims swap
    between torch's ``[out, in]`` and JAX's ``[in, out]`` (either way)."""
    if kernel and dim is not None and dim >= ndim - 2:
        return 2 * ndim - 3 - dim
    return dim


def spec_on(dim: Optional[int]) -> PartitionSpec:
    """The spec splitting dimension ``dim`` over ``fsdp`` (None: whole)."""
    return PartitionSpec(*([None] * dim + ["fsdp"])) if dim is not None else PartitionSpec()


def _largest_free(shape: tuple, spec) -> Optional[int]:
    """The largest dimension ``spec`` leaves free, the lowest on ties: the
    policy over an ``fsdp`` axis of size 1, which divides every one."""
    base = list(spec) + [None] * (len(shape) - len(spec))
    free = [d for d in range(len(shape)) if base[d] is None]
    return max(free, key=lambda d: (shape[d], -d)) if free else None


def layout_specs(module: nn.Module, fsdp_plugin, world: int) -> dict:
    """``{name: PartitionSpec}`` of ``module``'s parameters as the
    accelerator stores them, in the torch layout: the JAX policy on each
    leaf's :func:`reference_shape`, its dimension mapped back. A world of
    one keeps an ``fsdp`` axis of size 1 (every dimension divides it), so
    the gathers and reduce-scatters run there too, as the identity."""
    out = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        ref = reference_shape(module, name, shape)
        if world > 1:
            dim = _dim_of(infer_param_shardings([(name, ref)], {"fsdp": world},
                                                fsdp_plugin)[name])
        elif fsdp_plugin.sharding_strategy == "NO_SHARD" or not shape \
                or int(np.prod(shape)) < fsdp_plugin.min_weight_size_to_shard:
            dim = None
        else:
            dim = _largest_free(ref, ())
        out[name] = spec_on(swap_dim(dim, len(shape), _is_kernel(module, name, len(shape))))
    return out


def zero_specs(params: list, param_specs: list, world: int, min_size_to_shard: int) -> dict:
    """``{name: PartitionSpec}`` of each parameter's AdamW moments under
    ZeRO (``params``: ``(name, shape)`` pairs in the JAX layout,
    ``param_specs`` their specs): ``infer_opt_state_shardings`` over the
    ``count`` and ``mu``/``nu`` leaves of optax's AdamW state. A world of
    one keeps an ``fsdp`` axis of size 1, as :func:`layout_specs` does."""
    leaves = [("count", ())] + [(f"{m}/{name}", shape) for m in ("mu", "nu")
                                for name, shape in params]
    specs = infer_opt_state_shardings(leaves, {"fsdp": world}, params=params,
                                      param_shardings=param_specs,
                                      min_size_to_shard=min_size_to_shard)
    out = {}
    for (name, shape), spec in zip(params, param_specs):
        out[name] = specs[f"mu/{name}"]
        if world == 1 and not any(spec) and shape \
                and int(np.prod(shape)) >= min_size_to_shard:
            out[name] = spec_on(_largest_free(shape, ()))
    return out


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


class ShardedLayout:
    """Where a prepared module's parameters live across the process group,
    and the collectives that put them together.

    ``specs`` (``layout_specs``) name each leaf's shard dimension;
    :meth:`shard` replaces each sharded parameter's data, in place, by
    this process's chunk, so an optimizer built on the parameters steps
    the chunks. ``gather_in_remat`` (``FULL_SHARD`` with activation
    checkpointing): a decoder layer's gather runs inside its checkpoint and
    again in the backward's recompute; otherwise the gathered weights are
    kept for the backward (one gather a layer a step). ``remat_policy``:
    the plugin's, for every layer, or None. ``grad_scale`` multiplies the
    reduce-scattered gradients (the accelerator sets it: 1 for a loss
    weighted by its label share, else 1 / world). ``gathers`` counts layer
    gathers (both the forward's and the recompute's)."""

    def __init__(self, module: nn.Module, specs: Mapping, rank: int, world: int,
                 compute_dtype=torch.float32, gather_in_remat: bool = False,
                 remat_policy: Optional[str] = None, reduce_dtype=torch.float32):
        self.specs = dict(specs)
        self.dims = {n: _dim_of(s) for n, s in self.specs.items()}
        self.full_shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
        self.rank, self.world = rank, world
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

    def shard(self, module: nn.Module):
        """Each sharded parameter's data becomes this process's chunk (a
        contiguous copy; the parameter object stays, so optimizers keep
        it)."""
        with torch.no_grad():
            for name, p in module.named_parameters():
                if self.sharded(name) and tuple(p.shape) == self.full_shapes[name]:
                    p.data = chunk_of(p.data, self.dims[name], self.rank, self.world).clone()

    def full_state_dict(self, module: nn.Module) -> dict:
        """Every parameter whole (gathered, no autograd) and the buffers,
        on this process's device: what an unsharded module's
        ``state_dict`` holds."""
        out = {}
        with torch.no_grad():
            for name, t in module.state_dict().items():
                if self.sharded(name):
                    t = self._all_gather([t], (self.dims[name],))[0]
                out[name] = t
        return out

    def load_full(self, module: nn.Module, state_dict: Mapping):
        """Copy whole tensors into the module, each parameter's chunk where
        it is sharded."""
        params = dict(module.named_parameters())
        with torch.no_grad():
            for name, value in state_dict.items():
                value = torch.as_tensor(value)
                if name in params:
                    target = params[name]
                    target.copy_(chunk_of(value, self.dims.get(name), self.rank, self.world))
                else:
                    module.get_buffer(name).copy_(value)

    # -- the collectives --------------------------------------------------

    def _full_shape(self, shape, dim):
        full = list(shape)
        full[dim] *= self.world
        return tuple(full)

    def _all_gather(self, chunks: list, dims) -> list:
        from ..utils.operations import all_gather_into

        if self.world == 1:
            return list(chunks)
        flat = torch.cat([c.reshape(-1) for c in chunks])
        out = all_gather_into(flat).view(self.world, -1)
        wholes, offset = [], 0
        for c, d in zip(chunks, dims):
            part = out[:, offset:offset + c.numel()].reshape(self.world, *c.shape)
            wholes.append(torch.cat(part.unbind(0), dim=d))
            offset += c.numel()
        return wholes

    def _reduce_scatter(self, wholes: list, dims) -> list:
        from ..utils.operations import reduce_scatter

        if self.world == 1:
            return [g.to(self.reduce_dtype) * self.grad_scale if self.grad_scale != 1.0
                    else g.to(self.reduce_dtype) for g in wholes]
        rows = [torch.stack(g.to(self.reduce_dtype).chunk(self.world, dim=d))
                .reshape(self.world, -1) for g, d in zip(wholes, dims)]
        mine = reduce_scatter(torch.cat(rows, dim=1).reshape(-1), scale=self.grad_scale)
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
        (the sharded ones gathered, in one collective); the layers' leaves
        as stored (f32 chunks), which :meth:`gather_layer` puts together
        inside the layer loop."""
        params = list(module.named_parameters())
        gathered = [(n, p) for n, p in params if self.sharded(n) and not self._in_layers(n)]
        out = dict(zip((n for n, _ in gathered), self._gather(
            [p for _, p in gathered], [self.dims[n] for n, _ in gathered]))) if gathered else {}
        for n, p in params:
            if n not in out:
                out[n] = p if self._in_layers(n) or not p.is_floating_point() \
                    else p.to(self.compute_dtype)
        return {n: out[n] for n, _ in params}

    def gather_layer(self, prefix: str, params: Mapping, stacked: bool = False) -> dict:
        """One decoder layer's parameters (module-relative names under
        ``prefix``), whole and in the compute dtype: the sharded ones
        all-gathered in one collective (counted in :attr:`gathers`), the
        others cast. ``stacked``: ``params`` are one layer's slices of
        ``[num_layers, ...]`` leaves, so a leaf's shard dimension is one
        less (a leaf split over the layer axis is put together beforehand,
        :meth:`gather_stacked`)."""
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
        the layer axis (dim 0) gathered whole now, the rest as they are."""
        out = dict(stacked)
        names = [rel for rel in stacked if self.dims.get(prefix + rel) == 0]
        if names:
            wholes = self._gather([stacked[r] for r in names], [0] * len(names))
            out.update(zip(names, wholes))
        return out


def sharded_layout_of(module: nn.Module) -> Optional[ShardedLayout]:
    """The :class:`ShardedLayout` a prepared module's parameters follow,
    or None."""
    return getattr(module, "_sharded_layout", None)
