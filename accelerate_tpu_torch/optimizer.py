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
from .utils.operations import _group, all_gather_into, reduce, reduce_scatter


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
        self._views: list = []  # (whole parameter, chunk view, dim, rank, world)
        self._sharded_ids: set = set()  # parameters whose gradients are chunks
        self._chunk_layout: dict = {}  # id(parameter) -> (dim, whole shape) of a chunk
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

    def sharded_grads(self) -> tuple:
        """``(chunks, whole)``: the gradients that are this process's chunk
        of a leaf (FSDP chunks, ZeRO views), and those every process holds
        whole and equal."""
        chunks, whole = [], []
        for p in self._params():
            if p.grad is not None:
                (chunks if id(p) in self._sharded_ids else whole).append(p.grad)
        return chunks, whole

    def shard_state(self, names: dict, layout=None, rank: int = 0, world: int = 1,
                    kernels=()):
        """Lay the optimizer state out over the process group: ``names``
        maps ``id(parameter)`` to its name in the model, ``layout`` is the
        model's :class:`~accelerate_tpu_torch.parallel.sharding.ShardedLayout`
        (or None), ``kernels`` the names of ``torch.nn.Linear`` weights,
        whose JAX layout swaps the last two dims. Under ``zero_sharding``
        every trainable parameter's moments get their spec
        (``sharding.zero_specs``), and a replicated parameter whose moments
        take a dimension is replaced in ``param_groups`` by a view of its
        chunk. Call before the first update."""
        from .parallel.sharding import _dim_of, chunk_of, spec_on, swap_dim, zero_specs

        trainable = [p for p in self._params() if p.requires_grad]
        rows = []  # (parameter, name, whole shape in the torch layout, is a kernel)
        for i, p in enumerate(trainable):
            name = names.get(id(p), f"param_{i}")
            if layout is not None and layout.sharded(name):
                self._sharded_ids.add(id(p))
                self._chunk_layout[id(p)] = (layout.dims[name], layout.full_shapes[name])
            shape = layout.full_shapes.get(name, tuple(p.shape)) if layout is not None \
                else tuple(p.shape)
            rows.append((p, name, shape, name in kernels and len(shape) >= 2))
        if not self.zero_sharding:
            return

        def reference(shape, kernel):
            return (*shape[:-2], shape[-1], shape[-2]) if kernel else shape

        dims = [layout.dims.get(name) if layout is not None else None for _, name, _, _ in rows]
        specs = zero_specs(
            [(name, reference(shape, kernel)) for _, name, shape, kernel in rows],
            [spec_on(swap_dim(d, len(shape), kernel))
             for d, (_, _, shape, kernel) in zip(dims, rows)],
            world, self.zero_min_size_to_shard)
        self.opt_state_shardings = specs
        replace = {}
        for p, name, shape, kernel in rows:
            dim = swap_dim(_dim_of(specs[name]), len(shape), kernel)
            if dim is None or id(p) in self._sharded_ids:
                continue
            if self.optimizer.state.get(p):
                raise ValueError("prepare the optimizer before its first step: ZeRO lays "
                                 "out the state it creates")
            view = torch.nn.Parameter(chunk_of(p.data, dim, rank, world))
            self._views.append((p, view, dim, rank, world))
            self._sharded_ids.add(id(view))
            self._chunk_layout[id(view)] = (dim, tuple(p.shape))
            replace[id(p)] = view
        for group in self.optimizer.param_groups:
            group["params"] = [replace.get(id(p), p) for p in group["params"]]

    def param_layouts(self) -> list:
        """For each parameter of ``param_groups``, in order: ``(dim, whole
        shape)`` of the leaf it is this process's chunk of (``dim`` None for
        a whole parameter)."""
        return [self._chunk_layout.get(id(p), (None, tuple(p.shape))) for p in self._params()]

    def reduce_zero_grads(self, scale: float = 1.0):
        """At the sync step: each ZeRO view's gradient becomes its chunk of
        the sum over processes of its parameter's whole gradient, times
        ``scale`` (one reduce-scatter a parameter); the whole gradient is
        dropped."""
        for p, view, dim, _, world in self._views:
            if p.grad is None:
                continue
            g = p.grad
            if world > 1:
                rows = torch.stack(g.chunk(world, dim=dim))
                g = rows.reshape(world * rows.shape[1], *rows.shape[2:])
            view.grad = reduce_scatter(g, scale=scale)
            p.grad = None

    def _gather_zero_params(self):
        """After an update: every process's updated chunks back into each
        whole parameter (one all-gather a parameter)."""
        for p, view, dim, _, world in self._views:
            if world == 1:
                continue
            with torch.no_grad():
                mine = view.detach().contiguous()
                if dim == 0 and p.data.is_contiguous():
                    all_gather_into(mine.clone(), out=p.data)
                else:
                    parts = all_gather_into(mine).view(world, *mine.shape)
                    p.data.copy_(torch.cat(parts.unbind(0), dim=dim))

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

