"""The Accelerator on one GPU: prepare the objects of a training loop, run
the loop (accumulate, backward, clip, step) or the fused train step, and
checkpoint, log and gather around it.

Counterpart of ``accelerate_tpu/accelerator.py`` for one process on one
device. The JAX package captures an apply function and a parameter pytree
into jitted steps; here the prepared model keeps a torch module whose f32
master parameters the torch optimizer updates in place, and every step
casts them to the compute dtype inside the differentiated function, so the
gradients reach the masters' ``.grad`` in f32.

Two ways to train, with the same arithmetic in the same order:

* the loop a user writes: ``with accelerator.accumulate(model): loss =
  accelerator.backward(loss_fn, batch)`` (the loss divided by the
  accumulation count, scaled under fp16, its gradients added into the
  masters' ``.grad``), ``clip_grad_norm_`` at a sync step, then the
  prepared optimizer's ``step`` and ``zero_grad`` and the scheduler's
  ``step``, which act only at a sync step;
* ``compile_train_step``: one call does a whole update over a leading
  microbatch dim: gradients, under fp16 the unscale, the global-norm clip
  ``min(1, max / (norm + 1e-6))``, then the update the loop's ``step()``
  applies too (``AcceleratedOptimizer._apply``: under fp16 skipped when a
  gradient is not finite), and metrics as device tensors. The bf16 and
  fp32 steps never read a device value on the host.

Around the loop: ``profile`` (a ``torch.profiler`` session with the input
pipeline's counters and the serving engines'), ``autocast`` (the active
policy) and the preemption handler (SIGTERM latches
:attr:`Accelerator.preemption_requested`, which a serving engine built with
``accelerator=`` answers by draining). ``serving_stats`` is shared by every
``ServingEngine(accelerator=...)``: ``serving_metrics()`` and
``log(include_serving=True)`` read it; ``gateway_stats`` likewise by every
``ServingGateway(accelerator=...)`` (``gateway_metrics()``,
``log(include_gateway=True)``).

Multi-device meshes, FSDP (its activation checkpointing included),
optimizer-state host offload, ``LocalSGD`` and ``join_uneven_inputs`` are
not ported yet (ROADMAP.md, A8).
"""

from __future__ import annotations

import contextlib
import inspect
import warnings
from collections.abc import Mapping
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .data_loader import DataLoaderShard, prepare_data_loader, skip_first_batches
from .logging import get_logger
from .optimizer import AcceleratedOptimizer
from .precision import (
    GradScalerKwargs,
    policy_for,
    scale_loss,
)
from .scheduler import AcceleratedScheduler, LRScheduler
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    ProfileKwargs,
    ProjectConfiguration,
)
from .utils.operations import gather, gather_object, pad_across_processes, recursively_apply, reduce
from .serving.metrics import GatewayStats, ServingStats
from .utils.profiling import PipelineStats


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

    def load_state_dict(self, state_dict, strict: bool = True):
        """Copy ``state_dict`` (tensors or arrays) into the f32 masters on the
        model's device, in place: an optimizer prepared on the parameters
        keeps them."""
        return self.module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=strict)

    def train(self, mode: bool = True):
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to accelerate_tpu_torch yet "
                               f"(ROADMAP.md, A{item})")


def _accepts_generator(loss_fn) -> bool:
    """``loss_fn(params, batch, generator)`` rather than ``(params, batch)``."""
    try:
        return len(inspect.signature(loss_fn).parameters) >= 3
    except (TypeError, ValueError):
        return False


def _cast_params(module: nn.Module, dtype) -> dict:
    """The module's trainable parameters by name, floating ones cast to
    ``dtype`` (inside the autograd graph: gradients reach the masters)."""
    return {n: p.to(dtype) if p.is_floating_point() else p
            for n, p in module.named_parameters() if p.requires_grad}


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))


def _clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-6))``;
    return the norm before the clip."""
    gnorm = _global_norm(grads)
    factor = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return gnorm


def _is_scheduler(obj) -> bool:
    return isinstance(obj, (LRScheduler, torch.optim.lr_scheduler.LRScheduler))


def _is_dataloader(obj) -> bool:
    return (hasattr(obj, "__iter__")
            and not isinstance(obj, (Mapping, list, tuple, str, torch.Tensor, np.ndarray)))


class Accelerator:
    """One-GPU accelerator. ``mixed_precision`` is "no"/"fp32", "bf16"
    (f32 masters, bf16 compute) or "fp16" (with dynamic loss scaling; a
    ``GradScalerKwargs`` in ``kwargs_handlers`` configures it). Runs on
    ``cuda`` unless ``cpu=True``; raises without a card otherwise.

    ``seed`` seeds :attr:`generator`, the accelerator's own random stream,
    which a ``loss_fn(params, batch, generator)`` receives (the JAX
    package's ``next_rng_key``)."""

    def __init__(self, device_placement: bool = True, split_batches: bool = False,
                 mixed_precision: Optional[str] = None, gradient_accumulation_steps: int = 1,
                 cpu: bool = False, dataloader_config: Optional[DataLoaderConfiguration] = None,
                 rng_types: Optional[list] = None, log_with=None,
                 project_dir: Optional[str] = None,
                 project_config: Optional[ProjectConfiguration] = None,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 step_scheduler_with_optimizer: bool = True,
                 kwargs_handlers: Optional[list] = None, seed: int = 0, fsdp_plugin=None,
                 mesh_config=None, deepspeed_plugin=None):
        if fsdp_plugin is not None or deepspeed_plugin is not None:
            raise _not_ported("FSDP/ZeRO sharding, its remat and optimizer offload", "8")
        if mesh_config is not None:
            raise _not_ported("a device mesh", "8")
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        handlers = kwargs_handlers or []
        self.scaler_handler = next((h for h in handlers if isinstance(h, GradScalerKwargs)), None)
        self.profile_handler = next((h for h in handlers if isinstance(h, ProfileKwargs)), None)
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu)
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.split_batches = split_batches
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.rng_types = rng_types or ["numpy", "python"]
        self.policy = policy_for(self.mixed_precision)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.pipeline_stats = PipelineStats()
        # Shared by ServingEngine(accelerator=...) instances, so the engines
        # and this accelerator tell one story: serving_metrics(), profile()
        # and log(include_serving=True) read it.
        self.serving_stats = ServingStats()
        # The same for ServingGateway(accelerator=...): its HTTP counters.
        self.gateway_stats = GatewayStats()
        self._models: list[AcceleratedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[DataLoaderShard] = []
        self._custom_objects: list = []
        self._pending_saves: list = []
        self.step = 0  # microbatches since the last sync
        self.flag_tensor = None
        self._log_with = log_with
        self.trackers: list = []
        self.logger = get_logger(__name__)

    # -- state ----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def distributed_type(self):
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def sync_gradients(self) -> bool:
        """True when this microbatch ends an accumulation window."""
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, num_steps: int):
        self.gradient_state.plugin_kwargs.update({"num_steps": num_steps})

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @even_batches.setter
    def even_batches(self, value: bool):
        self.dataloader_config.even_batches = value

    @property
    def project_dir(self):
        return self.project_configuration.project_dir

    def on_main_process(self, function):
        return PartialState().on_main_process(function)

    def on_local_main_process(self, function):
        return PartialState().on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return PartialState().on_process(function, process_index=process_index)

    def wait_for_everyone(self):
        PartialState().wait_for_everyone()

    def print(self, *args, **kwargs):
        PartialState().print(*args, **kwargs)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return PartialState().split_between_processes(inputs, apply_padding=apply_padding)

    # -- prepare --------------------------------------------------------

    def prepare(self, *args, device_placement=None):
        """Prepare models (``nn.Module``), optimizers
        (``torch.optim.Optimizer``), schedulers (:class:`LRScheduler` or a
        torch ``LRScheduler``) and data loaders (a torch ``DataLoader``, a
        :class:`NumpyDataLoader` or any iterable of host batches), returning
        them in the same order; other objects pass through. Prepare a model
        before or with the optimizer built on its parameters."""
        prepared = [self._prepare_one(obj, device_placement) for obj in args]
        optimizers = [p for p in prepared if isinstance(p, AcceleratedOptimizer)]
        for sched in (p for p in prepared if isinstance(p, AcceleratedScheduler)):
            if not sched.optimizers:
                sched.optimizers = optimizers or list(self._optimizers)
        return prepared[0] if len(prepared) == 1 else tuple(prepared)

    def _prepare_one(self, obj, device_placement=None):
        if isinstance(obj, (AcceleratedModel, AcceleratedOptimizer, AcceleratedScheduler,
                            DataLoaderShard)):
            return obj
        if isinstance(obj, nn.Module):
            return self.prepare_model(obj, device_placement)
        if isinstance(obj, torch.optim.Optimizer):
            return self.prepare_optimizer(obj)
        if _is_scheduler(obj):
            return self.prepare_scheduler(obj)
        if _is_dataloader(obj):
            return self.prepare_data_loader(obj, device_placement)
        return obj

    def prepare_model(self, module: nn.Module, device_placement: Optional[bool] = None,
                      evaluation_mode: bool = False) -> AcceleratedModel:
        """Move the module to the device (in place: an optimizer built on its
        parameters keeps them) and wrap it with the precision policy."""
        if device_placement if device_placement is not None else self.device_placement:
            module.to(self.device)
        wrapped = AcceleratedModel(module, self.policy)
        if evaluation_mode:
            wrapped.eval()
        self._models.append(wrapped)
        return wrapped

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        wrapped = AcceleratedOptimizer(optimizer, scaler_kwargs=self.scaler_handler,
                                       use_loss_scaling=self.mixed_precision == "fp16",
                                       device=self.device)
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        wrapped = AcceleratedScheduler(scheduler, optimizers=[],
                                       step_with_optimizer=self.step_scheduler_with_optimizer,
                                       split_batches=self.dataloader_config.split_batches)
        self._schedulers.append(wrapped)
        return wrapped

    def prepare_data_loader(self, data_loader, device_placement=None) -> DataLoaderShard:
        cfg = self.dataloader_config
        loader = prepare_data_loader(
            data_loader, device=self.device,
            put_on_device=device_placement if device_placement is not None
            else self.device_placement,
            dispatch_batches=cfg.dispatch_batches, non_blocking=cfg.non_blocking,
            prefetch_size=cfg.prefetch_size, async_prefetch=cfg.async_prefetch,
            num_workers=cfg.num_workers)
        loader.pipeline_stats = self.pipeline_stats  # one breakdown over every loader
        self._dataloaders.append(loader)
        return loader

    def input_pipeline_metrics(self) -> dict:
        """The input pipeline over every prepared loader: ``data_wait_ms``
        (the loop blocked on data), ``stage_ms`` (collate and the copy to
        the card) and ``queue_depth``."""
        return self.pipeline_stats.summary()

    def serving_metrics(self) -> dict:
        """The serving engines' counters (TTFT, queue wait, decode
        tokens/s, slot occupancy, prefill and prefix-cache keys) of every
        ``ServingEngine(accelerator=self)``: ``ServingStats.summary``."""
        return self.serving_stats.summary()

    def gateway_metrics(self) -> dict:
        """The HTTP counters (requests by status class, SSE streams, in
        flight) of every ``ServingGateway(accelerator=self)``:
        ``GatewayStats.summary``."""
        return self.gateway_stats.summary()

    # -- gradient accumulation -------------------------------------------

    def _do_sync(self):
        if self.gradient_state.sync_with_dataloader and self.gradient_state.end_of_dataloader:
            self.step = 0
            self.gradient_state._set_sync_gradients(True)
        else:
            self.step += 1
            sync = (self.step % self.gradient_state.num_steps) == 0
            self.gradient_state._set_sync_gradients(sync or self.gradient_state.sync_each_batch)

    @contextlib.contextmanager
    def accumulate(self, *models):
        """One microbatch: sets :attr:`sync_gradients` for it (every
        ``gradient_accumulation_steps``-th microbatch, and the loader's last
        one)."""
        self._do_sync()
        yield

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Accumulate without syncing inside the block."""
        prev = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(prev)

    # -- backward and clipping --------------------------------------------

    def _model_and_optimizer(self, model, optimizer):
        model = model or (self._models[0] if self._models else None)
        optimizer = optimizer or (self._optimizers[0] if self._optimizers else None)
        if model is None or optimizer is None:
            raise RuntimeError("backward() needs a prepared model and optimizer "
                               "(call prepare first).")
        return model, optimizer

    def backward(self, loss_fn: Callable, batch, model: Optional[AcceleratedModel] = None,
                 optimizer: Optional[AcceleratedOptimizer] = None, **kwargs):
        """Gradients of ``loss_fn(params, batch[, generator])`` added into
        the masters' ``.grad``: ``params`` are the compute-cast parameters
        by name (the contract of ``compile_train_step``); the loss is
        divided by ``gradient_accumulation_steps`` and scaled under fp16.
        Returns the loss, unscaled and undivided, as an f32 device
        tensor."""
        model, optimizer = self._model_and_optimizer(model, optimizer)
        num_steps = self.gradient_state.num_steps
        cast = _cast_params(model.module, self.policy.compute_dtype)
        out = (loss_fn(cast, batch, self.generator) if _accepts_generator(loss_fn)
               else loss_fn(cast, batch))
        loss = out[0] if isinstance(out, tuple) else out
        scaled = loss / num_steps if num_steps > 1 else loss
        scale_loss(scaled, optimizer.loss_scale).float().backward()
        return loss.detach().float()

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Clip the gradients accumulated so far by their global norm,
        ``min(1, max_norm / (norm + 1e-6))``, as the fused step does; fp16
        gradients are unscaled first (and not again at ``step()``). Returns
        the norm before the clip of the first optimizer with gradients.
        Call it at a sync step (``if accelerator.sync_gradients:``) to clip
        the whole window's gradients."""
        if norm_type != 2.0:
            raise NotImplementedError("clip_grad_norm_ takes the L2 norm (norm_type=2) only")
        first = None
        for opt in self._optimizers:
            grads = opt.grads()
            if not grads:
                continue
            opt.unscale_()
            gnorm = _clip_by_global_norm_(grads, max_norm)
            first = gnorm if first is None else first
        return first

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0):
        """Clamp every accumulated gradient into ``[-clip_value, clip_value]``."""
        for opt in self._optimizers:
            for g in opt.grads():
                g.clamp_(-clip_value, clip_value)

    # -- the fused step ---------------------------------------------------

    def compile_train_step(self, loss_fn: Callable, model: Optional[AcceleratedModel] = None,
                           optimizer: Optional[AcceleratedOptimizer] = None,
                           accumulation_steps: Optional[int] = None,
                           max_grad_norm: Optional[float] = None,
                           grad_reduce_dtype=None) -> Callable:
        """Build ``step(batch) -> metrics`` over the prepared model and
        optimizer (the first of each unless given).

        ``loss_fn(params, batch[, generator])`` takes a dict of parameter
        tensors (the compute-cast parameters, by name) and returns a scalar
        loss or ``(loss, aux)``; :func:`fused_causal_lm_loss` builds one.
        With ``accumulation_steps > 1`` every batch leaf has a leading
        ``[accumulation_steps, ...]`` microbatch dim. The step's order is
        the module docstring's. Under fp16 loss scaling the finite flag is
        read on the host once per step to skip the update (GradScaler does
        the same for optimizers that cannot skip on the device).

        ``grad_reduce_dtype`` (e.g. ``torch.bfloat16``) differentiates with
        respect to the parameters cast to the compute dtype and then to
        that dtype, so the gradients are computed, and on several devices
        would be reduced, in it; they are upcast into the masters' ``.grad``
        microbatch by microbatch. A dtype other than the compute dtype also
        runs the forward in it, which warns."""
        model = model or self._models[0]
        optimizer = optimizer or self._optimizers[0]
        accum = accumulation_steps if accumulation_steps is not None \
            else self.gradient_state.num_steps
        compute = self.policy.compute_dtype
        if grad_reduce_dtype is not None and grad_reduce_dtype != compute:
            warnings.warn(
                f"grad_reduce_dtype={grad_reduce_dtype} differs from the mixed-precision compute "
                f"dtype {compute}: the forward will also run in the reduce dtype (the step "
                "differentiates with respect to the cast params), which changes accuracy beyond "
                "narrowing the gradients. Match the dtypes to narrow only the gradients.",
                stacklevel=2)
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        with_generator = _accepts_generator(loss_fn)

        def check_accum_shape(batch):
            if accum > 1:
                bad = [tuple(v.shape) for v in batch.values() if v.ndim == 0 or v.shape[0] != accum]
                if bad:
                    raise ValueError(
                        f"compile_train_step(accumulation_steps={accum}) expects every batch "
                        f"leaf to have a leading microbatch dim of {accum}; got shapes {bad}. "
                        "Reshape to [accum, micro, ...].")

        def call_loss(cast, micro):
            out = loss_fn(cast, micro, self.generator) if with_generator else loss_fn(cast, micro)
            return out[0] if isinstance(out, tuple) else out

        def narrow_backward(micro, loss_scale):
            """Gradients in ``grad_reduce_dtype``, upcast into ``.grad``."""
            leaves = {n: p.detach().to(compute).to(grad_reduce_dtype).requires_grad_()
                      for n, p in named if p.is_floating_point()}
            cast = {n: leaves.get(n, p) for n, p in named}
            loss = call_loss(cast, micro)
            scaled = scale_loss(loss / accum, loss_scale).float()
            grads = torch.autograd.grad(scaled, list(leaves.values()))
            for (n, p), g in zip(((n, p) for n, p in named if n in leaves), grads):
                if p.grad is None:
                    p.grad = g.to(p.dtype)
                else:
                    p.grad.add_(g.to(p.dtype))
            return loss

        def step(batch):
            check_accum_shape(batch)
            optimizer.optimizer.zero_grad(set_to_none=True)
            loss_scale = optimizer.loss_scale
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                micro = batch if accum == 1 else {k: v[i] for k, v in batch.items()}
                if grad_reduce_dtype is not None:
                    loss = narrow_backward(micro, loss_scale)
                else:
                    loss = call_loss(_cast_params(model.module, compute), micro)
                    scale_loss(loss / accum, loss_scale).float().backward()
                loss_sum = loss_sum + loss.detach().float()
            metrics = {"loss": loss_sum / accum}

            if max_grad_norm is not None:
                optimizer.unscale_()
                metrics["grad_norm"] = _clip_by_global_norm_(optimizer.grads(), max_grad_norm)
            finite = optimizer._apply()
            if finite is not None:
                metrics["loss_scale"] = optimizer.loss_scale.scale
                metrics["finite"] = finite
            return metrics

        return step

    # -- gathering ----------------------------------------------------------

    def gather(self, tensor):
        """Each process's tensors concatenated on dim 0 (on one process,
        the tensors)."""
        return gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """Gather, then drop the samples of the loader's last batch past the
        dataset's end (``GradientState.remainder``)."""
        try:
            recursively_apply(lambda x: x, input_data, error_on_other_type=True)
            all_tensors = True
        except TypeError:
            all_tensors = False
        objects = use_gather_object or not all_tensors
        data = gather_object(input_data) if objects else self.gather(input_data)
        if self.gradient_state.end_of_dataloader and self.gradient_state.remainder > 0:
            remainder = self.gradient_state.remainder

            def adjust(t):
                if isinstance(t, (list, tuple)) or getattr(t, "ndim", 0) > 0:
                    return t[:remainder]
                return t

            return adjust(data) if objects else recursively_apply(adjust, data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return reduce(tensor, reduction, scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return pad_across_processes(tensor, dim=dim, pad_index=pad_index, pad_first=pad_first)

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True) -> nn.Module:
        """The ``nn.Module`` under a prepared model."""
        return getattr(model, "module", model)

    def get_state_dict(self, model, unwrap: bool = True) -> dict:
        """The model's state dict, on the host."""
        return {k: v.detach().cpu() for k, v in self.unwrap_model(model).state_dict().items()}

    # -- preemption, autocast, profile ---------------------------------------

    #: Exit code of a run that saved its state on a preemption notice and
    #: stopped: EX_TEMPFAIL, which restart policies treat as retryable.
    PREEMPTED_EXIT_CODE = 75

    def install_preemption_handler(self, signals=None):
        """Latch :attr:`preemption_requested` on SIGTERM (or ``signals``),
        the notice schedulers send before they take the machine. The loop
        checks it between steps::

            accelerator.install_preemption_handler()
            for batch in loader:
                if accelerator.preemption_requested:
                    accelerator.save_state()
                    sys.exit(accelerator.PREEMPTED_EXIT_CODE)
                ...

        and the restarted run resumes with ``load_state()``. The handler only
        sets a flag, so a signal in the middle of a kernel launch is safe."""
        import signal

        self._preemption_requested = False
        for sig in signals or (signal.SIGTERM,):
            signal.signal(sig, self._on_preemption_signal)

    def _on_preemption_signal(self, signum, frame):
        self._preemption_requested = True

    @property
    def preemption_requested(self) -> bool:
        """True once a signal of :meth:`install_preemption_handler` arrived."""
        return getattr(self, "_preemption_requested", False)

    @contextlib.contextmanager
    def autocast(self, autocast_handler: Optional[AutocastKwargs] = None):
        """Yield the active precision policy. Prepared models and steps cast
        by it on every call already, so no ``torch.autocast`` region is
        opened, as the JAX package opens none."""
        yield self.policy

    def profile(self, profile_handler: Optional[ProfileKwargs] = None):
        """A :class:`~accelerate_tpu_torch.utils.profiling.ProfileSession`
        (a context manager) tracing the host, and the card when the
        accelerator runs on one, with the input pipeline's counters
        attached, and the serving engines' too. The traces go to the
        handler's ``output_trace_dir``, else the project's ``logging_dir``,
        else ``./torch_trace``."""
        from .utils.profiling import DEFAULT_TRACE_DIR

        handler = profile_handler or self.profile_handler or ProfileKwargs()
        log_dir = (handler.output_trace_dir or self.project_configuration.logging_dir
                   or DEFAULT_TRACE_DIR)
        return (handler.build(log_dir=log_dir, device=self.device)
                .attach_pipeline_stats(self.pipeline_stats)
                .attach_serving_stats(self.serving_stats)
                .attach_gateway_stats(self.gateway_stats))

    # -- triggers, memory ----------------------------------------------------

    def set_trigger(self):
        self.flag_tensor = True

    def check_trigger(self) -> bool:
        """True, once, after any process called :meth:`set_trigger`."""
        if self.flag_tensor:
            self.flag_tensor = None
            return True
        return False

    def free_memory(self, *objects):
        """Drop every prepared object and release their device memory."""
        from .utils.memory import release_memory

        self.wait_for_checkpoint()
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self.step = 0
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    # -- checkpointing --------------------------------------------------------

    def register_for_checkpointing(self, *objects):
        """Save and restore ``objects`` (with ``state_dict``/``load_state_dict``)
        with the accelerator's state."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError("All `objects` must have `state_dict`/`load_state_dict`: got "
                             f"invalid {invalid}")
        self._custom_objects.extend(objects)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """The loader, skipping the first ``num_batches`` of its next epoch."""
        return skip_first_batches(dataloader, num_batches)

    def save_state(self, output_dir: Optional[str] = None, blocking: bool = True, **kwargs):
        """Checkpoint models, optimizers, schedulers, loader positions, custom
        objects and RNG states. ``blocking=False`` returns once every tensor
        is copied to the host and writes the files in the background; the
        next save or load, or :meth:`wait_for_checkpoint`, waits for it."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, blocking=blocking)

    def wait_for_checkpoint(self):
        """Block until every background ``save_state`` write is on disk."""
        from .checkpointing import wait_for_saves

        wait_for_saves(self)

    def load_state(self, input_dir: Optional[str] = None, **kwargs):
        """Restore a ``save_state`` checkpoint into the prepared objects."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir)

    def save_model(self, model, save_directory: str, max_shard_size="10GB",
                   safe_serialization: bool = True):
        """Export the model's weights as (sharded) safetensors."""
        from .checkpointing import save_model

        return save_model(model, save_directory, max_shard_size, safe_serialization)

    # -- tracking ---------------------------------------------------------------

    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None):
        """Start the trackers of ``log_with`` (default: JSONL in the logging
        directory)."""
        from .tracking import resolve_trackers

        self.trackers = resolve_trackers(self._log_with, project_name,
                                         self.project_configuration.logging_dir, config=config,
                                         init_kwargs=init_kwargs or {})

    def log(self, values: dict, step: Optional[int] = None, log_kwargs: Optional[dict] = None,
            include_input_pipeline: bool = False, include_serving: bool = False,
            include_gateway: bool = False):
        """Log scalars to every tracker; ``include_input_pipeline`` adds the
        input pipeline's breakdown under ``input_pipeline/``,
        ``include_serving`` the serving engines' under ``serving/`` and
        ``include_gateway`` the gateways' under ``gateway/``."""
        if include_input_pipeline:
            from .tracking import with_input_pipeline_metrics

            values = with_input_pipeline_metrics(values, self.pipeline_stats)
        if include_serving:
            from .tracking import with_serving_metrics

            values = with_serving_metrics(values, self.serving_stats)
        if include_gateway:
            from .tracking import with_gateway_metrics

            values = with_gateway_metrics(values, self.gateway_stats)
        for tracker in self.trackers:
            tracker.log(values, step=step, **((log_kwargs or {}).get(tracker.name, {})))

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"{name} is not an available tracker: {[t.name for t in self.trackers]}")

    def end_training(self):
        """Wait for background checkpoint writes, then close the trackers."""
        self.wait_for_checkpoint()
        for tracker in self.trackers:
            tracker.finish()
        self.wait_for_everyone()
