"""The Accelerator on one GPU: prepare a model and an optimizer, and build
the fused train step.

Counterpart of ``accelerate_tpu/accelerator.py`` (``Accelerator.__init__``,
``prepare``, ``prepare_model``, ``prepare_optimizer``, ``AcceleratedModel``
and ``compile_train_step``), for one device. The JAX step is one jitted
function over immutable params; here it is eager PyTorch over the module's
f32 master parameters, updated in place by the torch optimizer, with the
same body in the same order:

1. gradients of the loss with respect to the compute-cast parameters (the
   cast happens inside the differentiated function, so the gradients reach
   the f32 masters in f32), summed over a leading microbatch dim with each
   microbatch's loss divided by the accumulation count;
2. under fp16 loss scaling, unscale and a finite check;
3. a global-norm clip ``min(1, max / (norm + 1e-6))`` over the f32 grads;
4. ``optimizer.step()``, skipped when the grads are not finite;
5. metrics ``loss``, ``grad_norm`` (with a clip) and, under loss scaling,
   ``loss_scale`` and ``finite``, as device tensors.

The bf16 and fp32 steps never read a device value on the host. Multi-device
meshes, FSDP (its activation checkpointing included), optimizer-state host
offload and ``grad_reduce_dtype`` are not ported yet (ROADMAP.md, A3 and
A8) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .optimizer import AcceleratedOptimizer
from .precision import (
    GradScalerKwargs,
    grads_finite,
    policy_for,
    scale_loss,
    unscale_grads,
    update_loss_scale,
)
from .utils.device import resolve_device


class AcceleratedModel:
    """A prepared model: the module (f32 master parameters on the
    accelerator's device) and the precision policy. Calling it runs the
    forward with the parameters cast to the compute dtype and the outputs
    cast to the output dtype."""

    def __init__(self, module: nn.Module, policy):
        self.module = module
        self.policy = policy

    @property
    def config(self):
        return self.module.config

    def __call__(self, *args, **kwargs):
        params = {name: p.to(self.policy.compute_dtype) if p.is_floating_point() else p
                  for name, p in self.module.named_parameters()}
        out = torch.func.functional_call(self.module, params, args, kwargs)
        return self.policy.cast_to_output(out)

    def parameters(self):
        return self.module.parameters()

    def named_parameters(self):
        return self.module.named_parameters()

    def state_dict(self):
        return self.module.state_dict()


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to accelerate_tpu_torch yet "
                               f"(ROADMAP.md, A{item})")


class Accelerator:
    """One-GPU accelerator. ``mixed_precision`` is "no"/"fp32", "bf16"
    (f32 masters, bf16 compute) or "fp16" (with dynamic loss scaling; a
    ``GradScalerKwargs`` in ``kwargs_handlers`` configures it). Runs on
    ``cuda`` unless ``cpu=True``; raises without a card otherwise."""

    def __init__(self, mixed_precision: Optional[str] = None,
                 gradient_accumulation_steps: int = 1, cpu: bool = False,
                 kwargs_handlers: Optional[list] = None, fsdp_plugin=None, mesh_config=None,
                 deepspeed_plugin=None):
        if fsdp_plugin is not None or deepspeed_plugin is not None:
            raise _not_ported("FSDP/ZeRO sharding, its remat and optimizer offload", "8")
        if mesh_config is not None:
            raise _not_ported("a device mesh", "8")
        self.device = resolve_device("cpu" if cpu else None)
        self.mixed_precision = str(mixed_precision) if mixed_precision is not None else "no"
        self.policy = policy_for(self.mixed_precision)
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self.scaler_handler = next((h for h in kwargs_handlers or []
                                    if isinstance(h, GradScalerKwargs)), None)
        self._models: list[AcceleratedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []

    def prepare(self, *args):
        """Prepare models (``nn.Module``) and optimizers
        (``torch.optim.Optimizer``), returning them in the same order; other
        objects pass through. Prepare a model before or with the optimizer
        built on its parameters."""
        prepared = []
        for obj in args:
            if isinstance(obj, nn.Module):
                prepared.append(self.prepare_model(obj))
            elif isinstance(obj, torch.optim.Optimizer):
                prepared.append(self.prepare_optimizer(obj))
            else:
                prepared.append(obj)
        return prepared[0] if len(prepared) == 1 else tuple(prepared)

    def prepare_model(self, module: nn.Module) -> AcceleratedModel:
        """Move the module to the device (in place: an optimizer built on its
        parameters keeps them) and wrap it with the precision policy."""
        module.to(self.device)
        wrapped = AcceleratedModel(module, self.policy)
        self._models.append(wrapped)
        return wrapped

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        wrapped = AcceleratedOptimizer(optimizer, scaler_kwargs=self.scaler_handler,
                                       use_loss_scaling=self.mixed_precision == "fp16",
                                       device=self.device)
        self._optimizers.append(wrapped)
        return wrapped

    def compile_train_step(self, loss_fn: Callable, model: Optional[AcceleratedModel] = None,
                           optimizer: Optional[AcceleratedOptimizer] = None,
                           accumulation_steps: Optional[int] = None,
                           max_grad_norm: Optional[float] = None,
                           grad_reduce_dtype=None) -> Callable:
        """Build ``step(batch) -> metrics`` over the prepared model and
        optimizer (the first of each unless given).

        ``loss_fn(params, batch)`` takes a dict of parameter tensors (the
        compute-cast parameters, by name) and returns a scalar loss or
        ``(loss, aux)``; :func:`fused_causal_lm_loss` builds one. With
        ``accumulation_steps > 1`` every batch leaf has a leading
        ``[accumulation_steps, ...]`` microbatch dim. The step's order is the
        module docstring's. Under fp16 loss scaling the finite flag is read
        on the host once per step to skip the update (GradScaler does the
        same for optimizers that cannot skip on the device)."""
        if grad_reduce_dtype is not None:
            raise _not_ported("grad_reduce_dtype (narrow gradient reduction)", "3")
        model = model or self._models[0]
        optimizer = optimizer or self._optimizers[0]
        accum = accumulation_steps if accumulation_steps is not None \
            else self.gradient_accumulation_steps
        compute = self.policy.compute_dtype
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        params = [p for _, p in named]
        scaler_kwargs = optimizer.scaler_kwargs

        def check_accum_shape(batch):
            if accum > 1:
                bad = [tuple(v.shape) for v in batch.values() if v.ndim == 0 or v.shape[0] != accum]
                if bad:
                    raise ValueError(
                        f"compile_train_step(accumulation_steps={accum}) expects every batch "
                        f"leaf to have a leading microbatch dim of {accum}; got shapes {bad}. "
                        "Reshape to [accum, micro, ...].")

        def step(batch):
            check_accum_shape(batch)
            optimizer.zero_grad(set_to_none=True)
            loss_scale = optimizer.loss_scale
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                micro = batch if accum == 1 else {k: v[i] for k, v in batch.items()}
                cast = {n: p.to(compute) if p.is_floating_point() else p for n, p in named}
                out = loss_fn(cast, micro)
                loss = out[0] if isinstance(out, tuple) else out
                scale_loss(loss / accum, loss_scale).float().backward()
                loss_sum = loss_sum + loss.detach().float()
            metrics = {"loss": loss_sum / accum}

            grads = [p.grad for p in params if p.grad is not None]
            finite = None
            if loss_scale is not None:
                for g, unscaled in zip(grads, unscale_grads(grads, optimizer.loss_scale)):
                    g.copy_(unscaled)
                finite = grads_finite(grads)
            if max_grad_norm is not None:
                gnorm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
                factor = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                for g in grads:
                    g.mul_(factor.to(g.dtype))
                metrics["grad_norm"] = gnorm
            if finite is None:
                optimizer.optimizer.step()
            else:
                if bool(finite):
                    optimizer.optimizer.step()
                optimizer.loss_scale = update_loss_scale(optimizer.loss_scale, finite,
                                                         scaler_kwargs)
                metrics["loss_scale"] = optimizer.loss_scale.scale
                metrics["finite"] = finite
            optimizer._record(finite)
            return metrics

        return step
