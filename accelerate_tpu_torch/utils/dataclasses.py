"""Configuration of the training loop, and the enums and handlers of the
process world.

Counterpart of ``accelerate_tpu/utils/dataclasses.py``: the enums
(``DistributedType`` ``:49``, ``PrecisionType``, ``RNGType``,
``LoggerType``, ``ComputeBackend``, ``CustomDtype``), ``KwargsHandler``
(``:126``), ``AutocastKwargs`` (``:146``),
``DistributedDataParallelKwargs``, ``DistributedInitKwargs`` /
``InitProcessGroupKwargs`` (``:235``), ``ProfileKwargs`` (``:265``),
``GradientAccumulationPlugin`` (``:291``), ``DataLoaderConfiguration``
(``:301``), ``ProjectConfiguration`` (``:323``), and the parallelism
plugins: ``FullyShardedDataParallelPlugin`` (``:372``),
``TensorParallelPlugin``, ``ContextParallelPlugin``,
``PipelineParallelPlugin``, ``ExpertParallelPlugin`` (``:442-497``),
``DeepSpeedPlugin`` (``:500``) and ``MegatronLMPlugin`` with
``add_model_config_to_megatron_parser`` (``:656-733``), and
``GradScalerKwargs`` (``:212``), which ``precision.py`` reads.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import json
import math
import os
import warnings
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Literal, Optional

from .environment import env_var, parse_flag_from_env


class EnumWithContains(enum.EnumMeta):
    """``"value" in MyEnum``."""

    def __contains__(cls, item):
        try:
            cls(item)
        except ValueError:
            return False
        return True


class BaseEnum(str, enum.Enum, metaclass=EnumWithContains):
    def __str__(self):
        return self.value

    @classmethod
    def list(cls):
        return list(map(str, cls))


class DistributedType(BaseEnum):
    """How the processes of a run share the work. ``NO``: one process and
    no process group. ``MULTI_GPU``: a process group over NCCL, one card a
    process; ``MULTI_CPU``: one over gloo on the CPU (also at a world size
    of 1, when a launcher asked for a process group). ``FSDP`` and
    ``DEEPSPEED``: an accelerator with a sharding plugin (its process
    group is either of the two). ``TENSOR_PARALLEL``, ``PIPELINE_PARALLEL``
    and ``MEGATRON_LM``: an accelerator whose mesh has a tp or pp axis
    above 1, or a Megatron-LM plugin."""

    NO = "NO"
    MULTI_CPU = "MULTI_CPU"
    MULTI_GPU = "MULTI_GPU"
    FSDP = "FSDP"
    TENSOR_PARALLEL = "TENSOR_PARALLEL"
    PIPELINE_PARALLEL = "PIPELINE_PARALLEL"
    DEEPSPEED = "DEEPSPEED"
    MEGATRON_LM = "MEGATRON_LM"


class PrecisionType(BaseEnum):
    NO = "no"
    FP32 = "fp32"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8 = "fp8"


class RNGType(BaseEnum):
    """Random streams that ``synchronize_rng_states`` makes equal across
    processes: torch's CPU generator, the card's, numpy's, python's, and a
    generator the caller passes."""

    TORCH = "torch"
    CUDA = "cuda"
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"


class LoggerType(BaseEnum):
    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    COMETML = "comet_ml"
    MLFLOW = "mlflow"
    AIM = "aim"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    JSONL = "jsonl"


class ComputeBackend(BaseEnum):
    """How a step runs: eagerly, or replayed as a captured CUDA graph (the
    serving engine's fixed-shape steps)."""

    EAGER = "eager"
    CUDA_GRAPH = "cuda_graph"


class CustomDtype(BaseEnum):
    """Sub-byte and non-native dtypes, for size accounting."""

    FP8_E4M3 = "fp8_e4m3"
    FP8_E5M2 = "fp8_e5m2"
    INT4 = "int4"
    INT2 = "int2"


@dataclass
class KwargsHandler:
    """Base of the handlers that configure one part of the accelerator."""

    def to_dict(self):
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self):
        """The fields whose values differ from the defaults."""
        default = self.__class__().to_dict()
        return {k: v for k, v in self.to_dict().items() if default[k] != v}


class DDPCommunicationHookType(BaseEnum):
    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    POWER_SGD = "power_sgd"
    BATCHED_POWER_SGD = "batched_power_sgd"


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """How the gradients are reduced across processes. The accelerator
    reduces them itself, once a sync step, in flat buckets of
    ``bucket_cap_mb`` megabytes (``Accelerator.backward`` and
    ``compile_train_step``), not through
    ``torch.nn.parallel.DistributedDataParallel``: every other field
    configures that wrapper, so a value other than its default warns that
    it changes nothing."""

    dim: int = 0
    broadcast_buffers: bool = True
    bucket_cap_mb: int = 25
    find_unused_parameters: bool = False
    check_reduction: bool = False
    gradient_as_bucket_view: bool = False
    static_graph: bool = False
    comm_hook: DDPCommunicationHookType = DDPCommunicationHookType.NO
    comm_wrapper: DDPCommunicationHookType = DDPCommunicationHookType.NO
    comm_state_option: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.bucket_cap_mb <= 0:
            raise ValueError(f"bucket_cap_mb must be positive, got {self.bucket_cap_mb}")
        # Field defaults, read directly: to_kwargs() builds a default
        # instance, which would come back here.
        ignored = [f.name for f in dataclasses.fields(self) if f.name != "bucket_cap_mb"
                   and getattr(self, f.name) != (f.default_factory() if f.default is
                                                 dataclasses.MISSING else f.default)]
        if ignored:
            warnings.warn(f"DistributedDataParallelKwargs({', '.join(sorted(ignored))}) has no "
                          "effect: the accelerator reduces the gradients itself and takes only "
                          "bucket_cap_mb.")


@dataclass
class DistributedInitKwargs(KwargsHandler):
    """Arguments of ``torch.distributed.init_process_group``, which
    ``PartialState`` calls: ``coordinator_address`` ("host:port") is the
    ``tcp://`` rendezvous, ``num_processes`` the world size,
    ``process_id`` the rank, ``local_device_ids`` the card (its first
    entry) and ``initialization_timeout`` the timeout. Unset fields come
    from the launcher's environment."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[list] = None
    initialization_timeout: timedelta = field(default_factory=lambda: timedelta(seconds=300))


InitProcessGroupKwargs = DistributedInitKwargs


@dataclass
class AutocastKwargs(KwargsHandler):
    """The handler ``Accelerator.autocast`` takes. The precision policy
    (f32 masters, compute and output dtypes) applies in every prepared call
    already, so there is no region to switch: both fields are kept for the
    JAX package's signature and read by nothing."""

    enabled: bool = True
    cache_enabled: bool = True


@dataclass
class ProfileKwargs(KwargsHandler):
    """How ``Accelerator.profile`` traces, on ``torch.profiler``.

    * ``activities``: "cpu" and/or "cuda" (or ``ProfilerActivity`` values);
      default the CPU, and the card when the session's device is one.
    * ``schedule_option``: ``{wait, warmup, active, repeat, skip_first}``
      over ``ProfileSession.step()`` calls: the trace covers the ``active``
      steps after ``skip_first + wait + warmup``, the whole block when
      ``active`` is 0 or missing. ``repeat`` is read by nothing, as in the
      JAX package.
    * ``on_trace_ready(session)``: called when a traced window closes, after
      its Chrome trace is written.
    * ``record_shapes``, ``profile_memory``, ``with_stack``, ``with_flops``:
      passed to ``torch.profiler.profile``.
    * ``output_trace_dir``: where the traces go (the first choice of
      ``Accelerator.profile``).
    * ``create_perfetto_link``, ``create_perfetto_trace``: the Chrome trace
      JSON the session writes opens in Perfetto as it is, so neither has
      anything left to do; kept for the JAX package's signature.
    """

    activities: Optional[list] = None
    schedule_option: Optional[dict] = None
    on_trace_ready: Optional[Callable] = None
    record_shapes: bool = False
    profile_memory: bool = False
    with_stack: bool = False
    with_flops: bool = False
    output_trace_dir: Optional[str] = None
    create_perfetto_link: bool = False
    create_perfetto_trace: bool = False

    def build(self, log_dir: Optional[str] = None, device=None):
        """A :class:`~accelerate_tpu_torch.utils.profiling.ProfileSession`
        writing under ``log_dir`` (else ``output_trace_dir``), tracing the
        card too when ``device`` is a CUDA device."""
        from .profiling import ProfileSession

        return ProfileSession(self, log_dir=log_dir or self.output_trace_dir, device=device)


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss-scaling config for fp16 (torch GradScaler's defaults);
    ``precision.py`` runs the scaling as a functional state on the
    device."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """Gradient accumulation: ``num_steps`` microbatches an update;
    ``adjust_scheduler`` steps schedulers only at sync steps;
    ``sync_with_dataloader`` syncs at the end of a loader whatever the
    window; ``sync_each_batch`` syncs every microbatch."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """How prepared loaders batch and stage. ``dispatch_batches`` (the main
    process reads, every process gets its slice), ``even_batches`` (the
    last round completed by cycling from the start) and ``split_batches``
    (the loader's batch is the global one) matter across processes only;
    ``non_blocking`` copies batches to the card from
    pinned memory; ``prefetch_size`` batches are staged ahead, by a
    background thread when ``async_prefetch``."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    non_blocking: bool = True
    use_stateful_dataloader: bool = True
    data_seed: Optional[int] = None
    prefetch_size: int = 2
    async_prefetch: bool = True
    num_workers: int = 1

    def __post_init__(self):
        if self.prefetch_size < 1:
            raise ValueError(f"prefetch_size must be >= 1, got {self.prefetch_size}")
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {self.num_workers}")


@dataclass
class ProjectConfiguration(KwargsHandler):
    """Where checkpoints and logs go. With ``automatic_checkpoint_naming``
    ``save_state()`` writes ``project_dir/checkpoints/checkpoint_<iteration>``
    and keeps at most ``total_limit`` of them."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None):
        """Derive the logging directory from ``project_dir``."""
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


# ---------------------------------------------------------------------------
# Sharding plugins: the training state over the process group
# ---------------------------------------------------------------------------

@dataclass
class FullyShardedDataParallelPlugin(KwargsHandler):
    """FSDP and ZeRO over the mesh's ``fsdp`` axis (by default every
    process); ``parallel/sharding.py`` decides each leaf's layout by the
    JAX package's rules and runs the collectives.

    ``sharding_strategy``: ``FULL_SHARD`` stores each large parameter as
    this process's chunk and all-gathers a decoder layer's parameters where
    the layer runs; with ``activation_checkpointing`` the gather sits inside
    the checkpointed layer, so the backward gathers again (reshard after
    forward). ``SHARD_GRAD_OP`` stores the same chunks and keeps one gather
    a step through the backward. ``NO_SHARD`` shards no parameter.
    ``HYBRID_SHARD`` is ``FULL_SHARD`` over the ``fsdp`` axis of a mesh
    whose ``dp`` axis replicates (``MeshConfig(dp=2, fsdp=2)``), as in
    the JAX package, where the two strategies share one policy.
    ``zero_sharding`` also shards the AdamW state of the replicated leaves
    (ZeRO-1/2); ``cpu_offload`` keeps the optimizer state in host memory
    between steps (``parallel/host_offload.py``); ``activation_checkpointing``
    recomputes every decoder layer under ``remat_policy`` ("dots",
    "nothing", "everything"). ``min_weight_size_to_shard``: smaller leaves
    stay whole. The ``FSDP_*`` environment variables override the fields,
    as in the JAX package. The knobs of torch's FSDP runtime that have no
    counterpart here stay no-ops, and the two that would look functional
    warn."""

    sharding_strategy: Literal["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD",
                               "HYBRID_SHARD"] = "FULL_SHARD"
    reshard_after_forward: bool = True
    state_dict_type: Literal["FULL_STATE_DICT", "SHARDED_STATE_DICT"] = "SHARDED_STATE_DICT"
    cpu_offload: bool = False
    activation_checkpointing: bool = False
    remat_policy: str = "dots"
    min_weight_size_to_shard: int = 2**14
    shard_largest_dim: bool = True
    zero_sharding: bool = False
    use_orig_params: bool = True          # parity no-op: parameters stay the module's own
    sync_module_states: bool = True       # parity no-op: every process loads the same weights
    forward_prefetch: bool = True         # parity no-op
    backward_prefetch: bool = True        # parity no-op
    param_dtype: Optional[str] = None     # not applied: see __post_init__'s warning
    auto_wrap_policy: Optional[Any] = None  # parity no-op: the unit is the decoder layer

    def __post_init__(self):
        env = os.environ
        self.sharding_strategy = env.get("FSDP_SHARDING_STRATEGY", self.sharding_strategy)
        self.state_dict_type = env.get("FSDP_STATE_DICT_TYPE", self.state_dict_type)
        if "FSDP_OFFLOAD_PARAMS" in env:
            self.cpu_offload = parse_flag_from_env("FSDP_OFFLOAD_PARAMS")
        if "FSDP_ACTIVATION_CHECKPOINTING" in env:
            self.activation_checkpointing = parse_flag_from_env("FSDP_ACTIVATION_CHECKPOINTING")
        if "FSDP_ZERO_SHARDING" in env:
            self.zero_sharding = parse_flag_from_env("FSDP_ZERO_SHARDING")
        if "FSDP_MIN_NUM_PARAMS" in env:
            self.min_weight_size_to_shard = int(env["FSDP_MIN_NUM_PARAMS"])
        if self.sharding_strategy not in ("FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD",
                                          "HYBRID_SHARD"):
            raise ValueError(f"unknown sharding_strategy {self.sharding_strategy!r}")
        if self.sharding_strategy == "NO_SHARD":
            self.min_weight_size_to_shard = 1 << 62  # nothing shards
        if self.sharding_strategy == "SHARD_GRAD_OP":
            self.reshard_after_forward = False
        if self.param_dtype is not None:
            warnings.warn(
                "FullyShardedDataParallelPlugin.param_dtype is not applied: master "
                "params stay fp32 and the compute dtype comes from mixed_precision. "
                "Set Accelerator(mixed_precision=...) instead.",
                stacklevel=2)
        if self.auto_wrap_policy is not None:
            warnings.warn(
                "FullyShardedDataParallelPlugin.auto_wrap_policy is ignored: sharding is "
                "decided per leaf by size and shape (min_weight_size_to_shard, "
                "shard_largest_dim), and a decoder layer is the unit of a gather.",
                stacklevel=2)


@dataclass
class TensorParallelPlugin(KwargsHandler):
    """Tensor parallelism over the mesh's ``tp`` axis: the Megatron
    column/row layout of ``parallel/sharding.py``'s ``ShardingRules``
    (``rules`` come before the defaults). ``sequence_parallelism`` is
    declared, as in the JAX package, where no code reads it; it has no
    effect here either."""

    tp_size: int = 1
    sequence_parallelism: bool = True
    rules: Optional[list] = None  # extra (regex, tp dim) rules


@dataclass
class ContextParallelPlugin(KwargsHandler):
    """Context parallelism over the mesh's ``cp`` axis: each process holds
    ``S / cp`` tokens of every row, and attention runs as ring attention
    (the K/V chunks rotate around the ``cp`` processes by send/recv under
    an online softmax in f32) or Ulysses (two all-to-alls around the flash
    kernel), ``ops/ring_attention.py``. ``ring_inner_chunk`` is the width
    of the key sub-tiles the ring's online softmax takes at a time."""

    cp_size: int = 1
    mode: Literal["ring", "all_gather"] = "ring"
    causal: bool = True
    ring_inner_chunk: int = 1024

    def __post_init__(self):
        if self.ring_inner_chunk < 1:
            raise ValueError(f"ring_inner_chunk must be >= 1, got {self.ring_inner_chunk}")


@dataclass
class PipelineParallelPlugin(KwargsHandler):
    """Pipeline parallelism over the mesh's ``pp`` axis: the GPipe schedule
    of ``parallel/pipeline.py`` over ``num_microbatches`` microbatches.
    ``schedule`` is declared with ``"1f1b"`` as in the JAX package, where
    no code reads it; both run GPipe."""

    pp_size: int = 1
    num_microbatches: int = 1
    schedule: Literal["gpipe", "1f1b"] = "gpipe"


@dataclass
class ExpertParallelPlugin(KwargsHandler):
    """MoE expert parallelism over the mesh's ``ep`` axis: ``ep_size`` above
    1 sets the axis, and the stacked expert leaves are split over it
    (``parallel/sharding.py``, ``ops/moe.py``). ``capacity_factor`` and
    ``num_experts`` are declared as in the JAX package, where no code reads
    them; the model's config sets both."""

    ep_size: int = 1
    capacity_factor: float = 1.25
    num_experts: Optional[int] = None


@dataclass
class DeepSpeedPlugin(KwargsHandler):
    """A DeepSpeed config (a dict, or a JSON file) translated onto
    :class:`FullyShardedDataParallelPlugin` (``to_fsdp_plugin``): stage 0
    replicates, stages 1-2 shard the optimizer state, stage 3 the
    parameters too; an ``offload_optimizer`` or ``offload_param`` device
    "cpu" is ``cpu_offload``. No DeepSpeed engine runs. The config's
    ``optimizer`` and ``scheduler`` sections build a torch optimizer and a
    scheduler (WarmupLR, WarmupDecayLR)."""

    hf_ds_config: Optional[Any] = None
    config_file: Optional[str] = None
    zero_stage: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    gradient_clipping: Optional[float] = None
    offload_optimizer_device: Optional[str] = None   # "none" | "cpu"
    offload_param_device: Optional[str] = None
    zero3_init_flag: Optional[bool] = None
    zero3_save_16bit_model: Optional[bool] = None

    def __post_init__(self):
        if self.config_file is None:
            self.config_file = os.environ.get(env_var("DEEPSPEED_CONFIG_FILE"), None)
        if self.config_file is not None and self.hf_ds_config is None:
            with open(self.config_file) as f:
                self.hf_ds_config = json.load(f)
        cfg = self.hf_ds_config or {}
        zero = cfg.get("zero_optimization", {})
        if self.zero_stage is None:
            self.zero_stage = int(os.environ.get(env_var("DEEPSPEED_ZERO_STAGE"),
                                                 zero.get("stage", 2)))
        if self.gradient_accumulation_steps is None:
            gas = cfg.get("gradient_accumulation_steps", 1)
            self.gradient_accumulation_steps = gas if gas != "auto" else 1
        if self.gradient_clipping is None:
            gc = cfg.get("gradient_clipping", None)
            self.gradient_clipping = None if gc in (None, "auto") else float(gc)
        if self.offload_optimizer_device is None:
            self.offload_optimizer_device = zero.get("offload_optimizer", {}).get("device", "none")
        if self.offload_param_device is None:
            self.offload_param_device = zero.get("offload_param", {}).get("device", "none")

    def _schedule_fn(self) -> Optional[Callable[[int], float]]:
        """``step -> lr`` from the config's ``scheduler`` section, or None:
        DeepSpeed's WarmupLR (log or linear warmup, then constant) and
        WarmupDecayLR (the warmup, then a linear decay to zero at
        ``total_num_steps``). "auto" values take DeepSpeed's defaults."""
        cfg = (self.hf_ds_config or {}).get("scheduler")
        if not cfg:
            return None
        p = {k: v for k, v in cfg.get("params", {}).items() if v != "auto"}
        lo = float(p.get("warmup_min_lr", 0.0))
        hi = float(p.get("warmup_max_lr", 1e-3))
        warmup = int(p.get("warmup_num_steps", 0))
        typ = str(cfg.get("type", "WarmupLR")).lower()
        # DeepSpeed's gammas: log -> log(1 + step) / log(max(2, warmup))
        # (1.0 at step warmup - 1), linear -> step / warmup.
        warmup_type = str(p.get("warmup_type", "log")).lower()
        if warmup_type not in ("log", "linear"):
            raise ValueError(f"unsupported DeepSpeed warmup_type {warmup_type!r}")

        def ramp(step):
            if warmup_type == "linear":
                frac = step / max(warmup, 1)
            else:
                frac = math.log(1.0 + step) / math.log(max(2, warmup))
            return lo + (hi - lo) * min(frac, 1.0)

        if typ == "warmuplr":
            def schedule(step):
                return hi if step >= warmup else ramp(step)
        elif typ == "warmupdecaylr":
            total = int(p.get("total_num_steps", max(warmup, 1)))

            def schedule(step):
                if step < warmup:
                    return ramp(step)
                if total <= warmup:
                    return hi
                return hi * min(max((total - step) / max(total - warmup, 1), 0.0), 1.0)
        else:
            raise ValueError(f"unsupported DeepSpeed scheduler type {cfg.get('type')!r}")
        return schedule

    def build_optimizer(self, params):
        """A torch optimizer over ``params`` from the config's
        ``optimizer`` section (Adam, AdamW, SGD), or None. DeepSpeed's
        FusedAdam decays weights decoupled, so "Adam" with a weight decay
        is AdamW, as in the JAX package. Its learning rate is the section's
        ``lr``; a ``scheduler`` section is :meth:`build_scheduler`."""
        cfg = (self.hf_ds_config or {}).get("optimizer")
        if not cfg:
            return None
        import torch

        p = {k: v for k, v in cfg.get("params", {}).items() if v != "auto"}
        lr = float(p.get("lr", 1e-3))
        betas = tuple(float(b) for b in p.get("betas", (0.9, 0.999)))
        eps = float(p.get("eps", 1e-8))
        wd = float(p.get("weight_decay", 0.0))
        typ = str(cfg.get("type", "AdamW")).lower()
        if typ in ("adam", "adamw"):
            if typ == "adam" and wd == 0.0:
                return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
        if typ == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=float(p.get("momentum", 0.0)))
        raise ValueError(f"unsupported DeepSpeed optimizer type {cfg.get('type')!r}")

    def build_scheduler(self):
        """An :class:`~accelerate_tpu_torch.scheduler.LRScheduler` over the
        config's schedule, or None; prepared, it writes the rate into the
        optimizer's ``param_groups`` at every applied update."""
        schedule = self._schedule_fn()
        if schedule is None:
            return None
        from ..scheduler import LRScheduler

        return LRScheduler(schedule)

    def to_fsdp_plugin(self) -> FullyShardedDataParallelPlugin:
        """The ZeRO stage as an FSDP policy: stage 3 ``FULL_SHARD``, 1-2
        ``SHARD_GRAD_OP`` with the optimizer state sharded, 0 ``NO_SHARD``."""
        if self.zero_stage >= 3:
            strategy = "FULL_SHARD"
        elif self.zero_stage >= 1:
            strategy = "SHARD_GRAD_OP"
        else:
            strategy = "NO_SHARD"
        return FullyShardedDataParallelPlugin(
            sharding_strategy=strategy,
            cpu_offload=(self.offload_optimizer_device == "cpu"
                         or self.offload_param_device == "cpu"),
            zero_sharding=self.zero_stage >= 1)


@dataclass
class MegatronLMPlugin(KwargsHandler):
    """A Megatron-LM configuration translated onto the mesh
    (:meth:`to_plugins`): the tp and pp degrees become the ``tp`` and
    ``pp`` axes, the distributed optimizer a ``SHARD_GRAD_OP`` FSDP plugin.
    No Megatron engine runs."""

    tp_degree: int = 1
    pp_degree: int = 1
    num_micro_batches: int = 1
    sequence_parallelism: bool = False
    use_distributed_optimizer: bool = False
    gradient_clipping: Optional[float] = 1.0
    recompute_activations: bool = False

    def to_plugins(self):
        """``(TensorParallelPlugin, PipelineParallelPlugin, FSDP plugin or
        None)`` of the Megatron degrees."""
        tp = TensorParallelPlugin(tp_size=self.tp_degree,
                                  sequence_parallelism=self.sequence_parallelism)
        pp = PipelineParallelPlugin(pp_size=self.pp_degree,
                                    num_microbatches=self.num_micro_batches)
        fsdp = None
        if self.use_distributed_optimizer:
            fsdp = FullyShardedDataParallelPlugin(sharding_strategy="SHARD_GRAD_OP")
        return tp, pp, fsdp


def add_model_config_to_megatron_parser(model_config, plugin: Optional[MegatronLMPlugin] = None):
    """A model config's dimensions under Megatron's argument names, checked
    against ``plugin``'s degrees (hidden size and heads divisible by tp,
    layers by pp), as Megatron checks them at setup. ``model_config`` is a
    config object or a dict (``hidden_size``/``n_embd``,
    ``num_hidden_layers``/``n_layer``, ...). Returns ``(plugin, args)``."""
    plugin = plugin or MegatronLMPlugin()
    get = (model_config.get if isinstance(model_config, dict)
           else lambda k, d=None: getattr(model_config, k, d))

    def first(*names, required=True):
        for n in names:
            v = get(n)
            if v is not None:
                return v
        if required:
            raise ValueError(f"model config provides none of {names}")
        return None

    args = {
        "num_layers": int(first("num_hidden_layers", "n_layer", "num_layers")),
        "hidden_size": int(first("hidden_size", "n_embd", "d_model")),
        "num_attention_heads": int(first("num_attention_heads", "n_head", "num_heads")),
        "max_position_embeddings": int(first(
            "max_position_embeddings", "n_positions", required=False) or 0) or None,
        "orig_vocab_size": int(first("vocab_size")),
    }
    if args["hidden_size"] % plugin.tp_degree:
        raise ValueError(
            f"hidden_size {args['hidden_size']} not divisible by tp_degree {plugin.tp_degree}")
    if args["num_attention_heads"] % plugin.tp_degree:
        raise ValueError(
            f"num_attention_heads {args['num_attention_heads']} not divisible by "
            f"tp_degree {plugin.tp_degree}")
    if args["num_layers"] % plugin.pp_degree:
        raise ValueError(
            f"num_layers {args['num_layers']} not divisible by pp_degree {plugin.pp_degree}")
    return plugin, args
