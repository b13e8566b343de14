"""Input-pipeline counters and trace sessions.

Counterpart of ``accelerate_tpu/utils/profiling.py``:

* ``PipelineStats`` (``:170``): how long the training loop waited for a
  batch (``data_wait_ms``), how long staging a batch took (``stage_ms``:
  collate, pinned copy and the start of the host-to-card copy) and how many
  staged batches stood ready (``queue_depth``).
  ``Accelerator.input_pipeline_metrics()`` reads it.
* ``ProfileSession`` (``:284``), on ``torch.profiler`` where the JAX package
  drives ``jax.profiler``: the same wait/warmup/active schedule over
  ``step()`` calls, one Chrome trace a traced window under ``log_dir``, and
  per-step snapshots of the attached ``PipelineStats``.
* ``annotate`` (``:446``) and ``save_device_memory_profile`` (``:453``).

The serving and gateway counters a session can carry in the JAX package
come with the serving engine and the gateway.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Optional


class PipelineStats:
    """Thread-safe step-time breakdown of the host input pipeline: the
    prefetch worker records ``stage_ms`` while the training thread records
    ``data_wait_ms`` and the queue depth it saw."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        """Zero every counter."""
        with self._lock:
            self._wait = [0.0, 0.0, 0.0, 0]   # sum, max, last, count
            self._stage = [0.0, 0.0, 0.0, 0]
            self._depth = [0, 0]              # sum, count

    @staticmethod
    def _add(acc, ms):
        acc[0] += ms
        acc[1] = max(acc[1], ms)
        acc[2] = ms
        acc[3] += 1

    def record_wait(self, ms: float):
        """One wait of the training loop for its next batch."""
        with self._lock:
            self._add(self._wait, ms)

    def record_stage(self, ms: float):
        """One staging of a batch."""
        with self._lock:
            self._add(self._stage, ms)

    def record_depth(self, depth: int):
        """Staged batches ready right after the loop took one."""
        with self._lock:
            self._depth[0] += int(depth)
            self._depth[1] += 1

    def summary(self) -> dict:
        """Scalars for ``Accelerator.log``: means, last and max of the waits
        and stages, mean queue depth and the counts."""
        with self._lock:
            wait, stage, depth = list(self._wait), list(self._stage), list(self._depth)
        return {
            "data_wait_ms": round(wait[0] / max(1, wait[3]), 3),
            "data_wait_ms_last": round(wait[2], 3),
            "data_wait_ms_max": round(wait[1], 3),
            "stage_ms": round(stage[0] / max(1, stage[3]), 3),
            "stage_ms_last": round(stage[2], 3),
            "stage_ms_max": round(stage[1], 3),
            "queue_depth": round(depth[0] / max(1, depth[1]), 3),
            "batches_waited": wait[3],
            "batches_staged": stage[3],
        }

    class _Timer:
        __slots__ = ("_record", "_t0")

        def __init__(self, record):
            self._record = record

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, *exc):
            # An exhausted or failed pull is not a batch wait.
            if exc_type is None:
                self._record((time.perf_counter() - self._t0) * 1e3)
            return False

    def time_wait(self):
        """Context timing one wait into ``data_wait_ms``."""
        return self._Timer(self.record_wait)

    def time_stage(self):
        """Context timing one staging into ``stage_ms``."""
        return self._Timer(self.record_stage)


#: Where a session writes when neither the handler nor the project names a
#: directory.
DEFAULT_TRACE_DIR = "./torch_trace"


class ProfileSession:
    """Context manager over ``torch.profiler.profile`` with the JAX
    package's schedule: ``skip_first + wait + warmup`` untraced ``step()``
    calls, then ``active`` traced ones (the whole block when ``active`` is
    0). Each traced window is written as a Chrome trace under ``log_dir``
    (:attr:`trace_files`), then ``on_trace_ready(session)`` runs;
    :attr:`profiler` is the window's ``torch.profiler.profile``, for
    ``key_averages()``. The card's activity is traced when ``device`` is a
    CUDA device::

        with accelerator.profile() as prof:
            for batch in loader:
                train_step(batch)
                prof.step()
    """

    def __init__(self, kwargs, log_dir: Optional[str] = None,
                 pipeline_stats: Optional[PipelineStats] = None, device=None):
        self.kwargs = kwargs
        self.log_dir = log_dir or kwargs.output_trace_dir or DEFAULT_TRACE_DIR
        sched = kwargs.schedule_option or {}
        self.wait = int(sched.get("wait", 0)) + int(sched.get("skip_first", 0))
        self.warmup = int(sched.get("warmup", 0))
        self.active = int(sched.get("active", 0)) or None  # None = the whole block
        self.device = device
        self.pipeline_stats = pipeline_stats
        self.profiler = None
        self.trace_files: list[str] = []
        self._step = 0
        self._tracing = False
        self._step_breakdowns: list[dict] = []

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        if self.kwargs.activities is None:
            on_card = self.device is not None and str(self.device).startswith("cuda")
            return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        names = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}
        return [names[str(a).lower()] if isinstance(a, str) else a
                for a in self.kwargs.activities]

    def _should_trace(self) -> bool:
        if self.active is None:
            return True
        start = self.wait + self.warmup
        return start <= self._step < start + self.active

    def _start(self):
        import torch

        os.makedirs(self.log_dir, exist_ok=True)
        k = self.kwargs
        self.profiler = torch.profiler.profile(
            activities=self._activities(), record_shapes=k.record_shapes,
            profile_memory=k.profile_memory, with_stack=k.with_stack, with_flops=k.with_flops)
        self.profiler.__enter__()
        self._tracing = True

    def _stop(self):
        if not self._tracing:
            return
        self.profiler.__exit__(None, None, None)
        self._tracing = False
        path = os.path.join(self.log_dir,
                            f"trace_{os.getpid()}_{len(self.trace_files)}.pt.trace.json")
        self.profiler.export_chrome_trace(path)
        self.trace_files.append(path)
        if self.kwargs.on_trace_ready is not None:
            self.kwargs.on_trace_ready(self)

    def __enter__(self):
        if self._should_trace():
            self._start()
        return self

    def __exit__(self, *exc):
        self._stop()
        return False

    def attach_pipeline_stats(self, stats: PipelineStats):
        """Attach input-pipeline counters so ``step()`` snapshots them."""
        self.pipeline_stats = stats
        return self

    def step(self):
        """End a step: snapshot the attached counters, then open or close
        the traced window as the schedule says."""
        if self.pipeline_stats is not None:
            self._step_breakdowns.append({"step": self._step, **self.pipeline_stats.summary()})
        self._step += 1
        should = self._should_trace()
        if should and not self._tracing:
            self._start()
        elif not should and self._tracing:
            self._stop()

    def data_breakdown(self) -> dict:
        """The input pipeline's latest summary; empty without counters."""
        if self.pipeline_stats is None:
            return {}
        return self.pipeline_stats.summary()

    @property
    def step_breakdowns(self) -> list[dict]:
        """One cumulative input-pipeline snapshot per ``step()``."""
        return list(self._step_breakdowns)


def annotate(name: str):
    """A named range in the trace (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


def save_device_memory_profile(path: str):
    """Pickle the card's allocator snapshot (``torch.cuda.memory._snapshot``)
    to ``path``; it loads in PyTorch's memory visualizer. Raises without a
    card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile needs a CUDA card: the CPU has no "
                           "device allocator to snapshot")
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
