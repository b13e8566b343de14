"""Configuration of the training loop.

Counterpart of the part of ``accelerate_tpu/utils/dataclasses.py`` the loop
reads: ``GradientAccumulationPlugin`` (``:291``), ``DataLoaderConfiguration``
(``:301``) and ``ProjectConfiguration`` (``:323``). ``GradScalerKwargs``
lives in ``precision.py``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional


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
