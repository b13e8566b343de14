"""Local SGD: data-parallel training that averages the parameters every
few steps instead of reducing the gradients every step.

Counterpart of ``accelerate_tpu/local_sgd.py`` (``LocalSGD``, ``:51``).
The JAX package stacks the replicas on a mesh axis and updates them under
``vmap``; here each process is a replica: every ``step`` is the fused train
step under ``no_sync()`` (its own gradients, no communication), and every
``local_sgd_steps`` steps, and on leaving the block, the parameters are
averaged over the process group (one bucketed all-reduce). Leaving also
averages the optimizer's floating state (Adam's moments), as the JAX
package does. With one process, or ``enabled=False``, ``step`` is the
plain fused step.

    with LocalSGD(accelerator, model, optimizer, loss_fn, local_sgd_steps=8) as lsgd:
        for batch in loader:
            metrics = lsgd.step(batch)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class LocalSGD:
    """A context manager running local steps, averaged every
    ``local_sgd_steps``."""

    def __init__(self, accelerator, model, optimizer, loss_fn: Callable,
                 local_sgd_steps: int = 8, enabled: bool = True,
                 max_grad_norm: Optional[float] = None):
        if accelerator.mixed_precision == "fp16":
            raise ValueError("LocalSGD does not support fp16 loss scaling (each replica would "
                             "keep its own scale); use bf16.")
        self.accelerator = accelerator
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.local_sgd_steps = int(local_sgd_steps)
        self.enabled = bool(enabled) and accelerator.num_processes > 1
        self.max_grad_norm = max_grad_norm
        self._step_count = 0
        self._step = None

    def __enter__(self):
        self._step = self.accelerator.compile_train_step(
            self.loss_fn, model=self.model, optimizer=self.optimizer,
            max_grad_norm=self.max_grad_norm)
        return self

    def step(self, batch) -> dict:
        """One local update on this process's ``batch``; averages the
        parameters after every ``local_sgd_steps``-th."""
        if not self.enabled:
            return self._step(batch)
        with self.accelerator.no_sync():
            metrics = self._step(batch)
        self._step_count += 1
        if self._step_count % self.local_sgd_steps == 0:
            self._sync()
        return metrics

    def _average(self, tensors):
        from .accelerator import _reduce_gradients

        n = self.accelerator.num_processes
        with torch.no_grad():
            _reduce_gradients(tensors, 1.0 / n, self.accelerator.ddp_handler.bucket_cap_mb)

    def _sync(self):
        self._average([p.data for p in self.model.module.parameters()])

    def __exit__(self, exc_type, exc, tb):
        if self.enabled and exc_type is None:
            self._sync()
            moments = [v for state in self.optimizer.optimizer.state.values()
                       for v in state.values()
                       if isinstance(v, torch.Tensor) and v.is_floating_point() and v.ndim > 0]
            if moments:
                self._average(moments)
        return False

    @property
    def num_local_steps(self) -> int:
        return self._step_count
