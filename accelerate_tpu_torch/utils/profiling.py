"""Input-pipeline counters.

Counterpart of ``PipelineStats`` in ``accelerate_tpu/utils/profiling.py``
(``:170``): how long the training loop waited for a batch
(``data_wait_ms``), how long staging a batch took (``stage_ms``: collate,
pinned copy and the start of the host-to-card copy) and how many staged batches
stood ready (``queue_depth``). ``Accelerator.input_pipeline_metrics()``
reads it. The JAX package's trace session is not ported
(``Accelerator.profile``, ROADMAP.md A3).
"""

from __future__ import annotations

import threading
import time


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
