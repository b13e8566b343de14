"""Optimizer wrapper over a ``torch.optim.Optimizer``.

Counterpart of the single-device part of ``accelerate_tpu/optimizer.py``
(``AcceleratedOptimizer``). The JAX wrapper owns an optax transformation,
its state and a gradient accumulator; here the torch optimizer owns its
state, and the gradients accumulate in the f32 master parameters' ``.grad``
(``Accelerator.backward``). This wrapper adds what the JAX one adds around
the update:

* ``step()`` applies only at a sync step of gradient accumulation, and
  ``zero_grad()`` does nothing while accumulating;
* under fp16 the loss scale (``precision.py``): the gradients are unscaled
  once (not again when ``Accelerator.clip_grad_norm_`` already did), a
  non-finite step is skipped and backs the scale off;
* the count of applied updates and whether the last one was skipped;
* every sync-step update, applied or skipped, consumes the gradients: they
  are dropped (``p.grad = None``), as the JAX wrapper drops its
  accumulator, so a loop that never calls ``zero_grad()`` does not apply a
  window's gradients twice.

One update, :meth:`AcceleratedOptimizer._apply`, serves both the loop's
``step()`` and the fused step (``Accelerator.compile_train_step``).

Across processes the gradients it sees are already reduced
(``Accelerator``), and under fp16 the skip decision is taken on the
all-reduced flag.

Sharded training state (reference ``:48-135``, ``:200-306``):

* ``zero_sharding`` (ZeRO-1/2): :meth:`shard_state` gives every trainable
  parameter its optimizer-state spec (``opt_state_shardings``, the JAX
  policy of ``infer_opt_state_shardings``). A parameter the FSDP layout
  already shards keeps its chunk; a replicated one whose moments take a
  dimension is stepped through a view of its chunk along that dimension,
  which replaces it in ``param_groups``, so the torch optimizer stores and
  updates that chunk only. At the sync step :meth:`reduce_zero_grads`
  reduce-scatters the whole gradient into the view's, and after the update
  the chunks are all-gathered back into the parameter.
* ``offload_to_host``: the state (each tensor shaped like its parameter)
  lives in host memory (``parallel/host_offload.py``) between updates: it
  is streamed onto the card for the update and out after it, and again
  after ``load_state_dict``. A frozen parameter has no state, as in the
  JAX package's LoRA case.

The fp8 statistics masks come with the fp8 path (ROADMAP.md, A9).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from .precision import (
    GradScalerKwargs,
    LossScaleState,
    grads_finite,
    make_loss_scale,
    unscale_grads,
    update_loss_scale,
)
from .state import GradientState
from .utils.operations import _group, reduce


class AcceleratedOptimizer:
    """Wraps a torch optimizer with accumulation, loss scaling and step
    bookkeeping. Created by ``Accelerator.prepare``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scaler_kwargs: Optional[GradScalerKwargs] = None,
                 use_loss_scaling: bool = False, device=None, offload_to_host: bool = False,
                 zero_sharding: bool = False, zero_min_size_to_shard: int = 2**11):
        self.optimizer = optimizer
        self.offload_to_host = offload_to_host
        self.zero_sharding = zero_sharding
        self.zero_min_size_to_shard = zero_min_size_to_shard
        #: {parameter name: spec of its optimizer state}, set by shard_state.
        self.opt_state_shardings: Optional[dict] = None
        # ZeRO views: (parameter, chunk view, dim, zero group, group the
        # gradient is summed over first or None, whether the reduce-scatter
        # applies the loss scale).
        self._views: list = []
        self._sharded_ids: set = set()  # parameters whose gradients are chunks
        # id(parameter) -> ({axis: dim} of its splits, whole shape)
        self._chunk_layout: dict = {}
        self._split_axes: dict = {}  # id(parameter) -> axes of >1 process it is split over
        self._pending: dict = {}  # id(parameter) -> group its gradient is summed over
        self.gradient_state = GradientState()
        self.scaler_kwargs = scaler_kwargs or GradScalerKwargs()
        self.loss_scale: Optional[LossScaleState] = make_loss_scale(
            self.scaler_kwargs, enabled=use_loss_scaling, device=device)
        self._steps_applied = 0
        self._step_was_skipped = False
        self._grads_already_unscaled = False  # set by Accelerator.clip_grad_norm_

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def grads(self) -> list:
        """The gradients of the optimizer's parameters that have one."""
        return [p.grad for group in self.optimizer.param_groups for p in group["params"]
                if p.grad is not None]

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def grads_by_axes(self) -> dict:
        """The gradients by the axes (of more than one process) that their
        parameter is split over: ``{frozenset(axes): [grads]}``, the whole
        ones under the empty set."""
        out: dict = {}
        for p in self._params():
            if p.grad is not None:
                out.setdefault(self._split_axes.get(id(p), frozenset()), []).append(p.grad)
        return out

    def grads_by_pending(self) -> list:
        """``[(group, scaled, grads)]``: the gradients that are not ZeRO
        views, by the group each is still to be summed over at the sync
        step (None: the accelerator's data group) and by whether that sum
        applies the loss scale (not for a chunk whose backward's
        reduce-scatter applied it)."""
        views = {id(view) for _, view, *_ in self._views}
        out: dict = {}
        for p in self._params():
            if p.grad is None or id(p) in views:
                continue
            group = self._pending.get(id(p))
            scaled = "fsdp" not in self._chunk_layout.get(id(p), ({}, None))[0]
            key = (id(group) if group is not None else None, scaled)
            out.setdefault(key, (group, scaled, []))[2].append(p.grad)
        return list(out.values())

    def shard_state(self, names: dict, mesh, layout=None, kernels=(), pending=None):
        """Lay the optimizer state out over ``mesh``: ``names`` maps
        ``id(parameter)`` to its name in the model, ``layout`` is the
        model's :class:`~accelerate_tpu_torch.parallel.sharding.ShardedLayout`
        (or None), ``kernels`` the names of ``torch.nn.Linear`` weights,
        whose JAX layout swaps the last two dims; ``pending(name)`` gives
        the axes a parameter's gradient is summed over at the sync step (the
        accelerator's data axes less those its backward reduced). Under
        ``zero_sharding`` every trainable parameter's moments get their
        spec (``sharding.zero_specs``), and a parameter whose moments take
        a dimension over the zero axis (``dp``, else ``fsdp``) that it is
        not split over is replaced in ``param_groups`` by a view of its
        chunk. Call before the first update."""
        from .parallel.sharding import chunk_of, swap_spec, zero_axis, zero_specs

        sizes = dict(mesh.shape)
        trainable = [p for p in self._params() if p.requires_grad]
        # (parameter, name, whole shape in the torch layout, is a kernel,
        # the axes its gradient is summed over at the sync step)
        rows = []
        for i, p in enumerate(trainable):
            name = names.get(id(p), f"param_{i}")
            splits = dict(layout.splits.get(name, {})) if layout is not None else {}
            if splits:
                self._chunk_layout[id(p)] = (splits, layout.full_shapes[name])
                axes = layout.split_axes(name)
                self._split_axes[id(p)] = axes
                if axes:
                    self._sharded_ids.add(id(p))
            rows_pending = tuple(pending(name)) if pending is not None else ()
            if pending is not None:
                self._pending[id(p)] = mesh.group(*rows_pending)
            shape = layout.full_shapes.get(name, tuple(p.shape)) if layout is not None \
                else tuple(p.shape)
            rows.append((p, name, shape, name in kernels and len(shape) >= 2, rows_pending))
        if not self.zero_sharding:
            return

        def reference(shape, kernel):
            return (*shape[:-2], shape[-1], shape[-2]) if kernel else shape

        axis = zero_axis(sizes)
        group = mesh.group(axis)
        specs = zero_specs(
            [(name, reference(shape, kernel)) for _, name, shape, kernel, _ in rows],
            [swap_spec(layout.specs[name], len(shape), kernel) if layout is not None
             else swap_spec((), len(shape), kernel) for _, name, shape, kernel, _ in rows],
            sizes, self.zero_min_size_to_shard)
        self.opt_state_shardings = specs
        replace = {}
        for p, name, shape, kernel, pending_axes in rows:
            spec = swap_spec(specs[name], len(shape), kernel)
            dim = next((d for d, ax in enumerate(spec) if ax == axis), None)
            splits = layout.splits.get(name, {}) if layout is not None else {}
            if dim is None or axis in splits:
                continue
            if self.optimizer.state.get(p):
                raise ValueError("prepare the optimizer before its first step: ZeRO lays "
                                 "out the state it creates")
            view = torch.nn.Parameter(chunk_of(p.data, dim, group.index, group.size))
            chunked = id(p) in self._sharded_ids
            before = tuple(ax for ax in pending_axes if ax != axis)
            self._views.append((p, view, dim, group, mesh.group(*before) if before else None,
                                not chunked))
            self._sharded_ids.add(id(view))
            self._chunk_layout[id(view)] = ({**splits, axis: dim},
                                            layout.full_shapes[name] if layout is not None
                                            else tuple(p.shape))
            self._split_axes[id(view)] = self._split_axes.get(id(p), frozenset()) | (
                {axis} if group.size > 1 else set())
            replace[id(p)] = view
        for group_ in self.optimizer.param_groups:
            group_["params"] = [replace.get(id(p), p) for p in group_["params"]]

    def param_layouts(self) -> list:
        """For each parameter of ``param_groups``, in order: ``(dim, whole
        shape)`` of the leaf it is this process's chunk of along one axis
        (``dim`` None for a whole parameter, or one split over several
        axes: :meth:`param_splits`)."""
        out = []
        for splits, whole in self.param_splits():
            out.append((next(iter(splits.values())) if len(splits) == 1 else None, whole))
        return out

    def param_splits(self) -> list:
        """For each parameter of ``param_groups``, in order: ``({axis:
        dim}, whole shape)`` of the leaf it is this process's chunk of."""
        return [self._chunk_layout.get(id(p), ({}, tuple(p.shape))) for p in self._params()]

    def reduce_zero_grads(self, scale: float = 1.0):
        """At the sync step: each ZeRO view's gradient becomes its chunk of
        the sum over the data axes of its parameter's gradient: summed over
        the axes other than the zero axis first (where any), then
        reduce-scattered over the zero axis, times ``scale`` (unless the
        parameter's own backward applied it); the parameter's gradient is
        dropped."""
        for p, view, dim, group, before, scaled in self._views:
            if p.grad is None:
                continue
            g = p.grad
            if before is not None:
                before.all_reduce(g)
            if group.size > 1:
                g = group.reduce_scatter(g, dim)
            g = g.contiguous()
            if scaled and scale != 1.0:
                g = g.mul_(scale)
            view.grad = g
            p.grad = None

    def _gather_zero_params(self):
        """After an update: every process's updated chunks back into each
        parameter (one all-gather a parameter over the zero axis)."""
        for p, view, dim, group, *_ in self._views:
            if group.size == 1:
                continue
            with torch.no_grad():
                p.data.copy_(group.all_gather(view.detach().contiguous(), dim))

    def moments(self, p) -> dict:
        """``p``'s optimizer-state tensors shaped like it (AdamW's two
        moments; not the step count)."""
        return {k: v for k, v in self.optimizer.state.get(p, {}).items()
                if k != "step" and isinstance(v, torch.Tensor) and v.shape == p.shape}

    def _state_to(self, kind: str):
        """Move every parameter's :meth:`moments` to host memory (``kind``
        "host") or onto its device."""
        from .parallel.host_offload import to_device, to_host

        for p in self._params():
            moments = self.moments(p)
            if moments:
                self.optimizer.state[p].update(
                    to_host(moments) if kind == "host" else to_device(moments, p.device))

    def state_memory_kinds(self) -> set:
        """The memory kinds of the :meth:`moments`: ``{"pinned_host"}``
        between offloaded updates on the card, ``{"unpinned_host"}`` on a
        CPU accelerator."""
        from .parallel.host_offload import tree_memory_kinds

        return tree_memory_kinds([self.moments(p) for p in self._params()])

    def state_bytes(self) -> int:
        """Bytes of the :meth:`moments`, as this process stores them."""
        return sum(v.numel() * v.element_size() for p in self._params()
                   for v in self.moments(p).values())

    @property
    def step_was_skipped(self) -> bool:
        """True if the last ``step()`` applied no update (accumulating, no
        gradients, or non-finite fp16 gradients)."""
        return self._step_was_skipped

    @property
    def steps_applied(self) -> int:
        """Number of applied updates."""
        return self._steps_applied

    def unscale_(self):
        """Divide the accumulated gradients by the loss scale, once per
        update."""
        if self.loss_scale is None or self._grads_already_unscaled:
            return
        grads = self.grads()
        for g, unscaled in zip(grads, unscale_grads(grads, self.loss_scale)):
            g.copy_(unscaled)
        self._grads_already_unscaled = True

    def _apply(self):
        """One update from the accumulated gradients: under fp16 unscale
        them (unless already done) and skip the update when one is not
        finite (one device read, as GradScaler does), updating the loss
        scale either way; then drop the gradients and count. Returns the
        finite flag (a device tensor) under loss scaling, else None."""
        finite = None
        if self.loss_scale is not None:
            self.unscale_()
            finite = grads_finite(self.grads())
            if _group() is not None:
                # Every process takes one decision: skipped where any saw a
                # non-finite gradient (the max of the flags).
                finite = reduce((~finite).float()) == 0
        applied = finite is None or bool(finite)
        if applied:
            if self.offload_to_host:
                self._state_to("device")
            self.optimizer.step()
            self._gather_zero_params()
            if self.offload_to_host:
                self._state_to("host")
        if finite is not None:
            self.loss_scale = update_loss_scale(self.loss_scale, finite, self.scaler_kwargs)
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                p.grad = None
        self._grads_already_unscaled = False
        self._step_was_skipped = not applied
        self._steps_applied += int(applied)
        return finite

    def step(self, closure=None):
        """Apply the accumulated gradients (:meth:`_apply`), at a sync step
        only."""
        if not self.gradient_state.sync_gradients or not self.grads():
            self._step_was_skipped = True
            return
        self._apply()

    def zero_grad(self, set_to_none: bool = True):
        """Drop the accumulated gradients; a no-op while accumulating."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)
            self._grads_already_unscaled = False

    def state_dict(self):
        """The torch optimizer's state dict, the applied-step count and the
        loss scale."""
        sd = {"optimizer": self.optimizer.state_dict(), "steps_applied": self.steps_applied}
        if self.loss_scale is not None:
            sd["loss_scale"] = tuple(t.clone() for t in self.loss_scale)
        return sd

    def load_state_dict(self, sd):
        """Restore from :meth:`state_dict`. The optimizer state is copied:
        torch's ``load_state_dict`` keeps a tensor of the right dtype and
        device as it is, so two optimizers would otherwise share moments."""
        self.optimizer.load_state_dict(copy.deepcopy(sd["optimizer"]))
        if self.offload_to_host:
            self._state_to("host")
        self._steps_applied = sd.get("steps_applied", 0)
        self._step_was_skipped = False
        if sd.get("loss_scale") is not None:
            device = self.loss_scale.scale.device if self.loss_scale is not None else None
            self.loss_scale = LossScaleState(*(torch.as_tensor(t, device=device)
                                               for t in sd["loss_scale"]))

    def __repr__(self):
        return f"AcceleratedOptimizer({self.optimizer.__class__.__name__})"

