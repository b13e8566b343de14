"""Optimizer wrapper over a ``torch.optim.Optimizer``.

Counterpart of the single-device part of ``accelerate_tpu/optimizer.py``
(``AcceleratedOptimizer``). The JAX wrapper owns an optax transformation and
its state; here the torch optimizer owns its state and this wrapper adds
what the JAX one adds around it: the fp16 loss scale (``precision.py``) and
the count of applied and skipped steps, kept without a host sync per step
(the fused step records a device-side finite flag that is read only when
:attr:`steps_applied` or :attr:`step_was_skipped` is asked for). The update
itself is ``Accelerator.compile_train_step``'s. ZeRO sharding, host offload
and fp8 statistics masks are not ported yet.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from .precision import GradScalerKwargs, LossScaleState, make_loss_scale


class AcceleratedOptimizer:
    """Wraps a torch optimizer with loss scaling and step bookkeeping.

    Created by ``Accelerator.prepare``; not usually constructed directly."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scaler_kwargs: Optional[GradScalerKwargs] = None,
                 use_loss_scaling: bool = False, device=None):
        self.optimizer = optimizer
        self.scaler_kwargs = scaler_kwargs or GradScalerKwargs()
        self.loss_scale: Optional[LossScaleState] = make_loss_scale(
            self.scaler_kwargs, enabled=use_loss_scaling, device=device)
        self._steps_applied = 0
        # Device-side finite flags of fused steps, drained on read.
        self._pending_finite: list = []
        self._last_finite = None

    @property
    def step_was_skipped(self) -> bool:
        """True if the last step applied no update (non-finite fp16 grads);
        reads the device-side flag of the last fused step."""
        return self._last_finite is not None and not bool(self._last_finite)

    @property
    def steps_applied(self) -> int:
        """Number of applied updates. Drains the pending flags of fused
        steps (one device read) when asked."""
        if self._pending_finite:
            self._steps_applied += int(torch.stack(self._pending_finite).sum())
            self._pending_finite = []
        return self._steps_applied

    def _record(self, finite=None):
        """Bookkeeping of one fused step: a device flag under loss scaling,
        else a plain count."""
        if finite is None:
            self._steps_applied += 1
        else:
            self._pending_finite.append(finite)
            self._last_finite = finite

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

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
        self._pending_finite, self._last_finite = [], None
        if sd.get("loss_scale") is not None:
            device = self.loss_scale.scale.device if self.loss_scale is not None else None
            self.loss_scale = LossScaleState(*(torch.as_tensor(t, device=device)
                                               for t in sd["loss_scale"]))

    def __repr__(self):
        return f"AcceleratedOptimizer({self.optimizer.__class__.__name__})"
