"""Configuration of the training loop, and the enums and handlers of the
process world.

Counterpart of ``accelerate_tpu/utils/dataclasses.py``: the enums
(``DistributedType`` ``:49``, ``PrecisionType``, ``RNGType``,
``LoggerType``, ``ComputeBackend``, ``CustomDtype``), ``KwargsHandler``
(``:126``), ``AutocastKwargs`` (``:146``),
``DistributedDataParallelKwargs``, ``DistributedInitKwargs`` /
``InitProcessGroupKwargs`` (``:235``), ``ProfileKwargs`` (``:265``),
``GradientAccumulationPlugin`` (``:291``), ``DataLoaderConfiguration``
(``:301``) and ``ProjectConfiguration`` (``:323``). ``GradScalerKwargs``
lives in ``precision.py``. The sharding plugins (FSDP, DeepSpeed, tensor,
context, pipeline and expert parallelism) come with ROADMAP.md, A8c/A8d.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import warnings
from dataclasses import asdict, dataclass, field
from datetime import timedelta
from typing import Callable, Optional


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
    of 1, when a launcher asked for a process group). The sharded kinds
    come with ROADMAP.md, A8c/A8d."""

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
class GradientAccumulationPlugin:
    """Gradient accumulation: ``num_steps`` microbatches an update;
    ``adjust_scheduler`` steps schedulers only at sync steps;
    ``sync_with_dataloader`` syncs at the end of a loader whatever the
    window; ``sync_each_batch`` syncs every microbatch."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def to_kwargs(self) -> dict:
        return asdict(self)


@dataclass
class DataLoaderConfiguration:
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
class ProjectConfiguration:
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
