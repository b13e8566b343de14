"""Learning-rate schedulers stepped with the optimizer.

Counterpart of ``accelerate_tpu/scheduler.py``: ``LRScheduler`` (``:24``, a
schedule function and a counter) and ``AcceleratedScheduler`` (``:48``),
which steps only where the optimizer stepped: at a sync step of gradient
accumulation and not after a skipped (non-finite fp16) update. The JAX
package writes the rate into an ``optax.inject_hyperparams`` state
(``:90-104``); here it goes into ``param_groups[i]["lr"]`` of every
prepared torch optimizer. A ``torch.optim.lr_scheduler.LRScheduler``
writes its own rates and is gated the same way.
"""

from __future__ import annotations

from typing import Callable

from .state import GradientState, PartialState


class LRScheduler:
    """A schedule function of the step count, and the count."""

    def __init__(self, schedule_fn: Callable[[int], float]):
        self.schedule_fn = schedule_fn
        self.count = 0

    def step(self):
        """Advance the count by one, unconditionally."""
        self.count += 1

    def get_last_lr(self):
        return [float(self.schedule_fn(self.count))]

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, sd):
        self.count = sd.get("count", 0)


class AcceleratedScheduler:
    """Steps ``scheduler`` in lockstep with the updates the optimizers
    really apply, and writes an :class:`LRScheduler`'s rate into their
    ``param_groups``."""

    def __init__(self, scheduler, optimizers, step_with_optimizer: bool = True,
                 split_batches: bool = False):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = GradientState()

    def step(self, *args, **kwargs):
        """Advance the schedule, unless accumulating or the last update was
        skipped."""
        if not self.step_with_optimizer:
            self.scheduler.step(*args, **kwargs)
            self._write_lr()
            return
        if not self.gradient_state.sync_gradients:
            return
        if any(getattr(opt, "step_was_skipped", False) for opt in self.optimizers):
            return
        # A schedule written for one process's batches advances once per
        # process when the global batch is num_processes times larger.
        for _ in range(1 if self.split_batches else PartialState().num_processes):
            self.scheduler.step(*args, **kwargs)
        self._write_lr()

    def _write_lr(self):
        if not isinstance(self.scheduler, LRScheduler):
            return  # a torch scheduler wrote its rates itself
        lr = self.scheduler.get_last_lr()[0]
        for opt in self.optimizers:
            for group in getattr(opt, "optimizer", opt).param_groups:
                group["lr"] = lr

    def get_last_lr(self):
        return self.scheduler.get_last_lr()

    def get_lr(self):
        """The rates of the current step, as the wrapped scheduler computes
        them (its last ones when it has no ``get_lr``)."""
        return self.scheduler.get_lr() if hasattr(self.scheduler, "get_lr") \
            else self.get_last_lr()

    def state_dict(self):
        return self.scheduler.state_dict()

    def load_state_dict(self, sd):
        self.scheduler.load_state_dict(sd)

    def __getattr__(self, name):
        # Anything else (``last_epoch``, ``base_lrs``, ...) is the wrapped
        # scheduler's. The wrapper's own attributes never reach here.
        if name == "scheduler":
            raise AttributeError(name)
        return getattr(self.scheduler, name)

