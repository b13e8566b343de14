"""The Accelerator: prepare the objects of a training loop, run the loop
(accumulate, backward, clip, step) or the fused train step, and
checkpoint, log and gather around it, in one process or in each process of
a process group (one device a process).

Counterpart of ``accelerate_tpu/accelerator.py``. The JAX package
captures an apply function and a parameter pytree into jitted steps; here
the prepared model keeps a torch module whose f32 master parameters the
torch optimizer updates in place, and every step casts them to the compute
dtype inside the differentiated function, so the gradients reach the
masters' ``.grad`` in f32.

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

Across processes (a process group, ``state.py``) the model is replicated
and each process reads its shard of the data: the gradients are summed
across processes by one explicit all-reduce at the sync step, after the
last microbatch and before the clip and the update, in buckets of
``DistributedDataParallelKwargs.bucket_cap_mb`` (``_reduce_gradients``). A
microbatch that does not sync communicates no gradients. A loss that
averages over its labels and says how many it has (``loss_fn.label_count``,
as ``fused_causal_lm_loss`` does) is weighted by this process's share of
the global label count (one all-reduce of the count a microbatch,
``_label_share``), and its gradients are summed; any other loss, a
per-process mean, gets the mean, which is the global mean because the
sharded loaders give every process the same batch size. So the clip sees, and returns,
the global norm, and every process applies the same update.

With an FSDP plugin (or a DeepSpeed config, translated onto one) the
training state is sharded over the process group instead
(``parallel/sharding.py``, the JAX package's policy leaf for leaf):
``prepare_model`` keeps each large parameter as this process's chunk and
hands the model a layout whose gathers put each decoder layer together
inside the layer loop; their backward reduce-scatters the gradients, so
the chunks' gradients arrive reduced. The replicated leaves are
all-reduced at the sync step as above, except under ZeRO
(``zero_sharding``), where each one whose optimizer state is sharded is
reduce-scattered into the view its optimizer steps, and its chunks are
all-gathered after the update. The clip's global norm adds the squared
norms of every process's chunks (one all-reduce) to those of the
replicated gradients, counted once. ``cpu_offload`` keeps the optimizer
state in host memory between updates; ``activation_checkpointing``
recomputes every decoder layer under the plugin's ``remat_policy``.

On a mesh (``mesh_config``, the launcher's ``--dp/--fsdp/--tp/--cp/--pp/--ep``,
or the tp/cp/pp/ep/Megatron plugins; ``parallel/mesh.py``) each process is one
device of the JAX package's mesh and holds what that device holds: the
``tp`` and ``pp`` plugins split leaves as the JAX rules do, the ``dp`` and
``fsdp`` processes read different rows, the ``cp`` ones different chunks
of each row. Gradients are summed over the data axes (dp, fsdp, cp; each
leaf over those its backward did not already reduce, the ``fsdp`` chunks
arriving reduce-scattered), label counts too; over ``tp`` and ``pp`` a
leaf is split or replicated with equal gradients on every process, and is
left as it is. ``HYBRID_SHARD`` is FULL_SHARD over ``fsdp``, replicated
over ``dp``. The clip's global norm counts every element once (each set
of split axes summed over its group). ZeRO shards the moments over
``dp``, else ``fsdp``. Under an ``ExpertParallelPlugin`` the ``ep``
processes of a data shard read the same rows and hold their block of each
MoE layer's experts (``ops/moe.py``); what they hold alike is left as it
is, as over ``tp``.
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
    DistributedDataParallelKwargs,
    DistributedInitKwargs,
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

    def __init__(self, module: nn.Module, policy, layout=None):
        self.module = module
        self.policy = policy
        #: The sharded layout of the parameters (FSDP), or None.
        self.layout = layout

    @property
    def config(self):
        return self.module.config

    def __call__(self, *args, **kwargs):
        params = _compute_params(self.module, self.policy.compute_dtype, self.layout)
        out = torch.func.functional_call(self.module, params, args, kwargs)
        return self.policy.cast_to_output(out)

    def parameters(self):
        return self.module.parameters()

    def named_parameters(self):
        return self.module.named_parameters()

    def state_dict(self):
        """The module's state dict; under FSDP every parameter whole (a
        collective: every process calls it)."""
        if self.layout is not None:
            return self.layout.full_state_dict(self.module)
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Copy ``state_dict`` (tensors or arrays) into the f32 masters on the
        model's device, in place: an optimizer prepared on the parameters
        keeps them. Under FSDP the tensors are whole and each process keeps
        its chunk."""
        if self.layout is not None:
            return self.layout.load_full(self.module, state_dict)
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


def _reduce_gradients(grads, scale: float, bucket_cap_mb: int = 25, dtype=None, extras=None,
                      group=None):
    """Sum ``grads`` in place across the process group, then multiply them
    by ``scale`` (skipped at 1): one all-reduce a bucket of at most
    ``bucket_cap_mb`` megabytes, in ``dtype`` (default the gradients'
    own). A bucket of one contiguous tensor already in that dtype is
    reduced where it lies; the others are flattened into one buffer and
    copied back. ``extras``, an f32 vector of per-process scalars (the
    step's loss), rides in the last flattened bucket when it is f32, or is
    reduced on its own, and is returned reduced and scaled the same way.
    Counts its calls and the last one's buckets on the function
    (``calls``, ``buckets``). ``group``: an ``AxisGroup`` of the mesh to
    sum over (default every process)."""
    import torch.distributed as dist

    pg = group.group if group is not None else None
    if group is not None and group.size == 1:
        if scale != 1.0:
            for g in grads:
                g.mul_(scale)
        return None if extras is None else extras * scale

    _reduce_gradients.calls += 1
    cap = bucket_cap_mb * 2**20
    buckets, current, size = [], [], 0
    for g in grads:
        nbytes = g.numel() * (dtype.itemsize if dtype is not None else g.element_size())
        if current and size + nbytes > cap:
            buckets.append(current)
            current, size = [], 0
        current.append(g)
        size += nbytes
    if current:
        buckets.append(current)
    _reduce_gradients.buckets = len(buckets)
    reduce_dtype = dtype if dtype is not None else (buckets[0][0].dtype if buckets else None)

    def in_place(bucket):
        return (len(bucket) == 1 and bucket[0].is_contiguous()
                and bucket[0].dtype == reduce_dtype)

    flattened = [i for i, bucket in enumerate(buckets) if not in_place(bucket)]
    ride = extras is not None and reduce_dtype == torch.float32 and bool(flattened)
    reduced = None
    for i, bucket in enumerate(buckets):
        if in_place(bucket):
            dist.all_reduce(bucket[0], op=dist.ReduceOp.SUM, group=pg)
            if scale != 1.0:
                bucket[0].mul_(scale)
            continue
        parts = [g.reshape(-1).to(reduce_dtype) for g in bucket]
        last = ride and i == flattened[-1]
        if last:
            parts.append(extras.reshape(-1))
        flat = torch.cat(parts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=pg)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        if last:
            reduced = flat[offset:]
    if extras is not None and not ride:
        reduced = extras.clone()
        dist.all_reduce(reduced, op=dist.ReduceOp.SUM, group=pg)
        if scale != 1.0:
            reduced.mul_(scale)
    return reduced


_reduce_gradients.calls = 0
_reduce_gradients.buckets = 0


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


def _compute_params(module: nn.Module, dtype, layout=None) -> dict:
    """What a forward takes: :func:`_cast_params`, or under a sharded
    layout every parameter as the layout hands it out (the leaves outside
    the decoder layers gathered, the layers' chunks for their loop)."""
    if layout is None:
        return _cast_params(module, dtype)
    return layout.compute_params(module)


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))


def _clip_sharded_(optimizer, max_norm: float, mesh=None) -> torch.Tensor:
    """:func:`_clip_by_global_norm_` over the gradients of ``optimizer``
    across the mesh, every element counted once: the squared norms of the
    gradients split over a set of axes are summed over that set's group
    (one all-reduce a set; without a mesh, the process group), and those
    of the gradients held whole are added once."""
    by_axes = optimizer.grads_by_axes()
    whole = by_axes.pop(frozenset(), [])
    if not by_axes:
        return _clip_by_global_norm_(whole, max_norm)
    from .utils.operations import reduce

    total = None
    for axes in sorted(by_axes, key=sorted):
        sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                          for g in by_axes[axes]]).square().sum()
        sq = mesh.group(*axes).all_reduce(sq) if mesh is not None else reduce(sq)
        total = sq if total is None else total + sq
    if whole:
        total = total + torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                     for g in whole]).square().sum()
    gnorm = total.sqrt()
    factor = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    for grads in [whole, *by_axes.values()]:
        for g in grads:
            g.mul_(factor.to(g.dtype))
    return gnorm


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
    """The accelerator of one process, alone or in a process group (one
    card a process). ``mixed_precision`` is "no"/"fp32", "bf16" (f32
    masters, bf16 compute) or "fp16" (with dynamic loss scaling; a
    ``GradScalerKwargs`` in ``kwargs_handlers`` configures it). Runs on
    ``cuda`` unless ``cpu=True``; raises without a card otherwise. In
    ``kwargs_handlers`` a ``DistributedInitKwargs`` configures the process
    group and a ``DistributedDataParallelKwargs`` the gradient buckets.
    ``fsdp_plugin`` (or ``deepspeed_plugin``, translated onto one) shards
    the training state over the process group (module docstring).

    ``mesh_config``, ``tp_plugin``, ``cp_plugin``, ``pp_plugin``,
    ``ep_plugin`` and ``megatron_lm_plugin`` lay the processes out over a
    mesh (module
    docstring; ``AcceleratorState`` resolves them).

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
                 mesh_config=None, deepspeed_plugin=None, tp_plugin=None, cp_plugin=None,
                 pp_plugin=None, megatron_lm_plugin=None, ep_plugin=None):
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        handlers = kwargs_handlers or []
        self.scaler_handler = next((h for h in handlers if isinstance(h, GradScalerKwargs)), None)
        self.profile_handler = next((h for h in handlers if isinstance(h, ProfileKwargs)), None)
        self.ddp_handler = next((h for h in handlers
                                 if isinstance(h, DistributedDataParallelKwargs)), None) \
            or DistributedDataParallelKwargs()
        init = next((h for h in handlers if isinstance(h, DistributedInitKwargs)), None)
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu,
                                      mesh_config=mesh_config, fsdp_plugin=fsdp_plugin,
                                      tp_plugin=tp_plugin, cp_plugin=cp_plugin,
                                      pp_plugin=pp_plugin, ep_plugin=ep_plugin,
                                      deepspeed_plugin=deepspeed_plugin,
                                      megatron_lm_plugin=megatron_lm_plugin,
                                      **({"init_kwargs": init} if init is not None else {}))
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
    def mesh(self):
        """The device mesh over the process group (``parallel/mesh.py``)."""
        return self.state.mesh

    def _data_group(self):
        """The processes that read different data: the mesh's ``dp``,
        ``fsdp`` and ``cp`` axes. Gradients and label counts are summed
        over it; ``tp`` and ``pp`` processes hold equal copies of what they
        do not split."""
        return self.state.mesh.group("dp", "fsdp", "cp")

    @property
    def fsdp_plugin(self):
        """The FSDP plugin (given, or translated from DeepSpeed), or None."""
        return self.state.fsdp_plugin

    @property
    def zero_sharding(self) -> bool:
        """Whether the optimizer state is ZeRO-sharded over the process
        group: the FSDP plugin's ``zero_sharding`` (DeepSpeed stages 1-3)."""
        plugin = self.state.fsdp_plugin
        return bool(plugin is not None and getattr(plugin, "zero_sharding", False))

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
        parameters keeps them) and wrap it with the precision policy. Under
        an FSDP plugin, or a mesh whose tensor, pipeline or expert plugin splits
        leaves, each split parameter keeps this process's chunk only (every
        process must hold the same weights before), and the model gets the
        layout its layer loops gather by (``parallel/sharding.py``)."""
        if device_placement if device_placement is not None else self.device_placement:
            module.to(self.device)
        layout = None
        plugin = self.state.fsdp_plugin
        mesh = self.state.mesh
        from .ops.quant import has_fp8_meta

        if has_fp8_meta(module) and (mesh.shape["tp"] > 1 or mesh.shape["pp"] > 1):
            raise NotImplementedError(
                "fp8 projections (use_fp8) under tp > 1 or pp > 1 are not ported: a split "
                "projection's amaxes and a pipeline stage's stacked statistics are not "
                "reduced over their axis yet (ROADMAP.md, A10)")
        tp_plugin = self.state.tp_plugin if mesh.shape["tp"] > 1 else None
        pp_plugin = self.state.pp_plugin if mesh.shape["pp"] > 1 else None
        ep_plugin = self.state.ep_plugin if mesh.shape["ep"] > 1 else None
        if plugin is not None or tp_plugin is not None or pp_plugin is not None \
                or ep_plugin is not None:
            from .parallel.sharding import ShardedLayout, layout_specs, sharding_summary

            specs = layout_specs(module, plugin, mesh, tp_plugin, pp_plugin, ep_plugin)
            remat = plugin is not None and plugin.activation_checkpointing
            layout = ShardedLayout(
                module, specs, mesh, compute_dtype=self.policy.compute_dtype,
                gather_in_remat=remat and plugin.reshard_after_forward,
                remat_policy=plugin.remat_policy if remat else None)
            layout.shard(module)
            layout.attach(module)
            self.logger.debug("Param sharding summary: %s", sharding_summary(specs))
        wrapped = AcceleratedModel(module, self.policy, layout)
        if evaluation_mode:
            wrapped.eval()
        self._models.append(wrapped)
        return wrapped

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        """Wrap a torch optimizer. Under a sharded layout it steps the
        chunks the model keeps; with ``zero_sharding`` its state is laid
        out by the JAX package's ZeRO policy over the mesh's ``dp`` axis,
        else ``fsdp`` (``AcceleratedOptimizer.shard_state``), and with
        ``cpu_offload`` it lives in host memory between updates. Prepare
        the model first (or with it, before it in ``prepare``). A prepared
        model's fp8 statistics are committed at each of its steps
        (``ops/quant.py``'s ``wrap_optimizer_for_fp8``)."""
        plugin = self.state.fsdp_plugin
        offload = bool(plugin is not None and plugin.cpu_offload)
        if offload:
            from .parallel.host_offload import supports_host_memory

            if not supports_host_memory(self.device):
                raise RuntimeError(
                    "fsdp_plugin.cpu_offload=True, but host memory cannot be pinned here; "
                    "the optimizer state would stay on the card")
        wrapped = AcceleratedOptimizer(optimizer, scaler_kwargs=self.scaler_handler,
                                       use_loss_scaling=self.mixed_precision == "fp16",
                                       device=self.device, offload_to_host=offload,
                                       zero_sharding=self.zero_sharding)
        from .ops.quant import has_fp8_meta, wrap_optimizer_for_fp8

        for model in self._models:
            if has_fp8_meta(model.module):
                wrap_optimizer_for_fp8(optimizer, model.module)
        layout = next((m.layout for m in self._models if m.layout is not None), None)
        if plugin is not None or layout is not None or self.zero_sharding:
            from .parallel.mesh import DATA_AXES
            from .parallel.sharding import _is_kernel

            names, kernels = {}, set()
            for model in self._models:
                for name, p in model.module.named_parameters():
                    names[id(p)] = name
                    if _is_kernel(model.module, name, p.ndim):
                        kernels.add(name)
            mesh = self.state.mesh

            def pending(name):
                reduced = {"fsdp"} if layout is not None and layout.sharded(name) else set()
                return tuple(ax for ax in DATA_AXES if mesh.shape[ax] > 1 and ax not in reduced)

            wrapped.shard_state(names, mesh, layout, kernels=kernels, pending=pending)
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        wrapped = AcceleratedScheduler(scheduler, optimizers=[],
                                       step_with_optimizer=self.step_scheduler_with_optimizer,
                                       split_batches=self.dataloader_config.split_batches)
        self._schedulers.append(wrapped)
        return wrapped

    def prepare_data_loader(self, data_loader, device_placement=None,
                            slice_fn_for_dispatch=None) -> DataLoaderShard:
        """This process's shard of ``data_loader`` on the device
        (:func:`~accelerate_tpu_torch.data_loader.prepare_data_loader`, with
        the ``DataLoaderConfiguration``)."""
        cfg = self.dataloader_config
        loader = prepare_data_loader(
            data_loader, device=self.device, mesh=self.state.mesh,
            split_batches=cfg.split_batches,
            put_on_device=device_placement if device_placement is not None
            else self.device_placement, rng_types=self.rng_types,
            dispatch_batches=cfg.dispatch_batches, even_batches=cfg.even_batches,
            slice_fn_for_dispatch=slice_fn_for_dispatch,
            use_seedable_sampler=cfg.use_seedable_sampler, data_seed=cfg.data_seed,
            non_blocking=cfg.non_blocking, prefetch_size=cfg.prefetch_size,
            async_prefetch=cfg.async_prefetch, num_workers=cfg.num_workers)
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
        """Accumulate without syncing inside the block: no update, and no
        gradient reduction across processes."""
        prev = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(prev)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches=None):
        """Run the block on inputs that may be uneven across processes.
        ``even_batches`` (when given) replaces that of every prepared
        loader's batch sampler, and the configuration's default for loaders
        prepared inside, for the block only. With ``even_batches=False``
        the processes may read different numbers of batches at the tail, so
        the block must run no collective per batch: compute locally, then
        aggregate once after the loop (``gather_for_metrics(...,
        use_gather_object=True)`` or ``pad_across_processes``), as in the
        JAX package. ``joinables`` is taken for the reference's signature:
        there is no ``torch.distributed.algorithms.Join`` to wrap, since the
        gradients are reduced by the accelerator, not by a DDP wrapper."""
        restore: list = []
        entered_with = len(self._dataloaders)
        previous = self.dataloader_config.even_batches
        if even_batches is not None:
            restore.append((self.dataloader_config, previous))
            self.dataloader_config.even_batches = even_batches
            for dl in self._dataloaders:
                sampler = getattr(dl.base_dataloader, "batch_sampler", None)
                for obj in (sampler, dl):
                    if hasattr(obj, "even_batches"):
                        restore.append((obj, obj.even_batches))
                        obj.even_batches = even_batches
        try:
            yield
        finally:
            for obj, value in restore:
                obj.even_batches = value
            if even_batches is not None:
                # Loaders prepared inside took the override: give them the
                # default they would have had.
                for dl in self._dataloaders[entered_with:]:
                    sampler = getattr(dl.base_dataloader, "batch_sampler", None)
                    for obj in (sampler, dl):
                        if hasattr(obj, "even_batches"):
                            obj.even_batches = previous

    # -- backward and clipping --------------------------------------------

    @property
    def _reduces_gradients(self) -> bool:
        """Gradients are reduced at this microbatch: a sync step, and a
        process group or a ZeRO view to hand its gradient."""
        return self.gradient_state.sync_gradients and (
            self.state.process_group or any(opt._views for opt in self._optimizers))

    def _grad_scale(self, loss_fn) -> float:
        """What the reductions multiply the summed gradients by: 1 for a
        loss weighted by its label share (``_label_share``), else 1 / the
        processes of the data group (the mean of their means)."""
        return 1.0 if hasattr(loss_fn, "label_count") else 1.0 / self._data_group().size

    def _reduce(self, optimizer, loss_fn, dtype=None, extras=None):
        """The sync step's reductions: each ZeRO view's gradient
        reduce-scattered (``reduce_zero_grads``), then every other
        gradient summed over the data axes its backward did not reduce
        (the ``fsdp`` chunks arrive reduce-scattered over ``fsdp``), with
        ``extras`` over the whole data group."""
        scale = self._grad_scale(loss_fn)
        optimizer.reduce_zero_grads(scale)
        if not self.state.process_group:
            return extras
        data = self._data_group()
        reduced = None
        for group, scaled, grads in optimizer.grads_by_pending():
            group = group if group is not None else data
            ride = extras is not None and reduced is None and scaled and group is data
            if group.size == 1 and not (ride or (scaled and self.num_processes == 1)):
                continue
            out = _reduce_gradients(grads, scale if scaled else 1.0,
                                    self.ddp_handler.bucket_cap_mb, dtype=dtype,
                                    extras=extras if ride else None,
                                    group=None if group.size == self.num_processes else group)
            if ride:
                reduced = out
        if extras is not None and reduced is None:
            reduced = _reduce_gradients([], scale, dtype=dtype, extras=extras,
                                        group=None if data.size == self.num_processes else data)
        return reduced

    def _weights_labels(self, model: AcceleratedModel) -> bool:
        """Whether a loss with a label count is weighted by its share at
        this microbatch: in a process group, when its gradients are reduced
        at it, and under a sharded layout always (its chunks reduce in
        every backward)."""
        return self.state.process_group and (self._reduces_gradients
                                              or model.layout is not None)

    def _clip(self, optimizer, max_norm: float):
        """The global-norm clip of ``optimizer``'s gradients: chunks and
        whole ones told apart across several processes; at one, where a
        chunk is the whole tensor, the same ops as without a group."""
        if self.num_processes > 1:
            return _clip_sharded_(optimizer, max_norm, self.state.mesh)
        return _clip_by_global_norm_(optimizer.grads(), max_norm)

    def _label_share(self, loss, count):
        """``loss``, the mean over this process's ``count`` labels, weighted
        by its share of every process's labels, and the global batch's
        loss: one all-reduce of ``[loss * count, count]``. The weighted
        losses add up to the global one, so their gradients are summed. At
        one process the weight is exactly 1."""
        import torch.distributed as dist

        count = count.to(torch.float32)
        pair = torch.stack([loss.detach().float() * count, count])
        data = self._data_group()
        if data.size > 1:
            dist.all_reduce(pair, op=dist.ReduceOp.SUM, group=data.group)
        total = pair[1].clamp(min=1.0)
        return loss * (count / total).to(loss.dtype), pair[0] / total

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
        At a sync step in a process group the accumulated gradients are then
        reduced across processes.

        Returns the loss, unscaled and undivided, as an f32 device tensor.
        In a process group it is the global batch's wherever the call
        communicates: at a sync step (the loss rides in the gradients'
        all-reduce), and at every call with a loss that has a
        ``label_count`` (its label share is all-reduced before the
        backward, ``_label_share``). At a microbatch that does not sync, a
        mean loss is this process's own: nothing is communicated there."""
        model, optimizer = self._model_and_optimizer(model, optimizer)
        num_steps = self.gradient_state.num_steps
        if model.layout is not None:
            model.layout.grad_scale = self._grad_scale(loss_fn)
        cast = _compute_params(model.module, self.policy.compute_dtype, model.layout)
        out = (loss_fn(cast, batch, self.generator) if _accepts_generator(loss_fn)
               else loss_fn(cast, batch))
        loss = out[0] if isinstance(out, tuple) else out
        reported = None
        if self.state.process_group and hasattr(loss_fn, "label_count"):
            loss, reported = self._label_share(loss, loss_fn.label_count(batch))
        scaled = loss / num_steps if num_steps > 1 else loss
        scale_loss(scaled, optimizer.loss_scale).float().backward()
        if self._reduces_gradients:
            extras = None if reported is not None else loss.detach().float().reshape(1)
            reduced = self._reduce(optimizer, loss_fn, extras=extras)
            reported = reported if reported is not None else reduced[0]
        return (reported if reported is not None else loss.detach()).float()

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Clip the gradients accumulated so far by their global norm,
        ``min(1, max_norm / (norm + 1e-6))``, as the fused step does; fp16
        gradients are unscaled first (and not again at ``step()``). Returns
        the norm before the clip of the first optimizer with gradients
        (across processes, of the reduced gradients: the global norm).
        Call it at a sync step (``if accelerator.sync_gradients:``) to clip
        the whole window's gradients."""
        if norm_type != 2.0:
            raise NotImplementedError("clip_grad_norm_ takes the L2 norm (norm_type=2) only")
        first = None
        for opt in self._optimizers:
            if not opt.grads():
                continue
            opt.unscale_()
            gnorm = self._clip(opt, max_norm)
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
        that dtype, so the gradients are computed, and across processes
        reduced, in it; they are upcast into the masters' ``.grad``
        microbatch by microbatch. A dtype other than the compute dtype also
        runs the forward in it, which warns.

        In a process group the gradients are reduced after the last
        microbatch, before the clip (module docstring), together with the
        step's loss: ``metrics["loss"]`` is the global one (inside
        ``no_sync()`` nothing is reduced, but FSDP chunks, which reduce in
        their backward).

        Under an FSDP plugin the sharded model's gradients are
        reduce-scattered in ``grad_reduce_dtype`` (default f32) inside the
        backward; ``activation_checkpointing`` recomputes every decoder
        layer, and ``cpu_offload`` runs the forward and backward with the
        optimizer state in host memory, then streams it in for the update
        and out after it.

        A model with fp8 projections (``use_fp8``) records each backward's
        amaxes, and the update commits them (``ops/quant.py``): each
        history rolls once per step, with the max over the step's
        microbatches of each operand's amax (the JAX step adds the
        microbatches' next statistics instead, ROADMAP.md C), and the
        statistics stay out of the clip. A skipped fp16 update drops them."""
        model = model or self._models[0]
        optimizer = optimizer or self._optimizers[0]
        accum = accumulation_steps if accumulation_steps is not None \
            else self.gradient_state.num_steps
        compute = self.policy.compute_dtype
        layout = model.layout
        if layout is not None:
            layout.reduce_dtype = grad_reduce_dtype or torch.float32
            grad_reduce_dtype = None  # the layout's reduce-scatters narrow the gradients
        if grad_reduce_dtype is not None and grad_reduce_dtype != compute:
            warnings.warn(
                f"grad_reduce_dtype={grad_reduce_dtype} differs from the mixed-precision compute "
                f"dtype {compute}: the forward will also run in the reduce dtype (the step "
                "differentiates with respect to the cast params), which changes accuracy beyond "
                "narrowing the gradients. Match the dtypes to narrow only the gradients.",
                stacklevel=2)
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        with_generator = _accepts_generator(loss_fn)
        from .ops.quant import discard_fp8_pending

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
            loss = out[0] if isinstance(out, tuple) else out
            if self._weights_labels(model) and hasattr(loss_fn, "label_count"):
                loss = self._label_share(loss, loss_fn.label_count(micro))[0]
            return loss

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
            discard_fp8_pending(model)  # this step's amaxes only, as in the JAX step
            optimizer.optimizer.zero_grad(set_to_none=True)
            for p, *_ in optimizer._views:
                p.grad = None
            if layout is not None:
                layout.grad_scale = self._grad_scale(loss_fn)
            loss_scale = optimizer.loss_scale
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                micro = batch if accum == 1 else {k: v[i] for k, v in batch.items()}
                if grad_reduce_dtype is not None:
                    loss = narrow_backward(micro, loss_scale)
                else:
                    loss = call_loss(_compute_params(model.module, compute, layout), micro)
                    scale_loss(loss / accum, loss_scale).float().backward()
                loss_sum = loss_sum + loss.detach().float()
            loss = loss_sum / accum
            if self._reduces_gradients:
                loss = self._reduce(optimizer, loss_fn, dtype=grad_reduce_dtype,
                                    extras=loss.reshape(1))[0]
            metrics = {"loss": loss}

            if max_grad_norm is not None:
                optimizer.unscale_()
                metrics["grad_norm"] = self._clip(optimizer, max_grad_norm)
            finite = optimizer._apply()
            if finite is not None:
                metrics["loss_scale"] = optimizer.loss_scale.scale
                metrics["finite"] = finite
            return metrics

        # The optimizer the step updates, for benchmarks (the JAX step
        # exposes its executables the same way).
        step.optimizer = optimizer
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
        from .utils.other import extract_model_from_parallel

        return extract_model_from_parallel(model, keep_fp32_wrapper)

    def get_state_dict(self, model, unwrap: bool = True) -> dict:
        """The model's state dict, on the host; under FSDP every parameter
        whole (a collective: every process calls it)."""
        layout = getattr(model, "layout", None)
        if layout is None:
            from .parallel.sharding import sharded_layout_of

            layout = sharded_layout_of(self.unwrap_model(model))
        state = (layout.full_state_dict(self.unwrap_model(model)) if layout is not None
                 else self.unwrap_model(model).state_dict())
        return {k: v.detach().cpu() for k, v in state.items()}

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
        """True, once, after any process called :meth:`set_trigger` (across
        a process group, one all-reduce of the flags)."""
        flag = torch.tensor([1.0 if self.flag_tensor else 0.0])
        if self.state.process_group:
            flag = reduce(flag)
        if flag.item() > 0:
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

    def load_state(self, input_dir: Optional[str] = None, load_kwargs: Optional[dict] = None,
                   via_host: Optional[bool] = None, **kwargs):
        """Restore a ``save_state`` checkpoint into the prepared objects.
        ``via_host`` (default: from the checkpoint's ``world.json``, True
        when another number of processes wrote it) reads every tensor whole
        and keeps this process's chunk, so a checkpoint saved by 2
        processes restores into 1 or 4."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, load_kwargs=load_kwargs,
                                      via_host=via_host)

    def save_model(self, model, save_directory: str, max_shard_size="10GB",
                   safe_serialization: bool = True):
        """Export the model's weights as (sharded) safetensors."""
        from .checkpointing import save_model

        return save_model(self, model, save_directory, max_shard_size, safe_serialization)

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
