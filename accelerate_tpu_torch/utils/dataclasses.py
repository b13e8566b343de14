"""Configuration of the training loop.

Counterpart of the part of ``accelerate_tpu/utils/dataclasses.py`` the loop
reads: ``AutocastKwargs`` (``:146``), ``ProfileKwargs`` (``:265``),
``GradientAccumulationPlugin`` (``:291``), ``DataLoaderConfiguration``
(``:301``) and ``ProjectConfiguration`` (``:323``). ``GradScalerKwargs``
lives in ``precision.py``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Callable, Optional


@dataclass
class AutocastKwargs:
    """The handler ``Accelerator.autocast`` takes. The precision policy
    (f32 masters, compute and output dtypes) applies in every prepared call
    already, so there is no region to switch: both fields are kept for the
    JAX package's signature and read by nothing."""

    enabled: bool = True
    cache_enabled: bool = True


@dataclass
class ProfileKwargs:
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
    """How prepared loaders batch and stage. ``dispatch_batches``,
    ``even_batches`` and ``split_batches`` matter across processes only
    (ROADMAP.md, A8); ``non_blocking`` copies batches to the card from
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
