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
all-reduced flag. ZeRO sharding and host offload are ROADMAP.md, A8c; the
fp8 statistics masks come with the fp8 path (A9).
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
                 use_loss_scaling: bool = False, device=None):
        self.optimizer = optimizer
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
            self.optimizer.step()
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
        self._steps_applied = sd.get("steps_applied", 0)
        self._step_was_skipped = False
        if sd.get("loss_scale") is not None:
            device = self.loss_scale.scale.device if self.loss_scale is not None else None
            self.loss_scale = LossScaleState(*(torch.as_tensor(t, device=device)
                                               for t in sd["loss_scale"]))

    def __repr__(self):
        return f"AcceleratedOptimizer({self.optimizer.__class__.__name__})"
