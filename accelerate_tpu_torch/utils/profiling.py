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
* ``GraphCaptureWatcher``, the counterpart of ``CompileWatcher`` (``:21``):
  the serving engine's steps run as captured CUDA graphs, so "did serving
  build anything after warmup" is a count of graph captures.

A session also carries the serving engine's ``ServingStats``
(``attach_serving_stats``, JAX ``:359``), the gateway's ``GatewayStats``
(``attach_gateway_stats``, ``:365``) and a span sink
(``attach_tracer``, ``:371``): each ``step()`` then emits a ``train_step``
span in the serving engine's Chrome-trace format.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Optional


class GraphCaptureWatcher:
    """Counts the serving engine's step captures: the counterpart of the
    JAX package's ``CompileWatcher``, whose compiles are what a CUDA graph
    capture is here.

    :meth:`record` takes a step's name and its signature (the step and the
    shapes and types of its inputs). A signature not seen before is an
    event: on the card the engine records each step once, when it captures
    its graph (with the seconds the capture took); on the CPU, where steps
    run eagerly, it records every run, so an event there is a step run
    with inputs of a shape it never had. ``events`` lists the events since
    the last :meth:`reset` (empty = nothing captured since warmup, the
    engine's steady state); :meth:`counts` counts every signature ever
    seen, by step. Thread-safe. ``on_event(name, seconds_or_None)`` runs for each
    event, outside the lock; its exceptions are swallowed."""

    def __init__(self, on_event=None):
        self._on_event = on_event
        self._lock = threading.Lock()
        self._seen: dict = {}            # signature -> step name
        self._events: list[tuple] = []   # (name, seconds or None)
        self._lifetime_secs = 0.0        # capture seconds, resets included

    def record(self, name: str, signature, seconds: Optional[float] = None) -> bool:
        """Note one run (or capture) of step ``name``; True when its
        signature is new."""
        with self._lock:
            if signature in self._seen:
                return False
            self._seen[signature] = name
            self._events.append((name, seconds))
            self._lifetime_secs += seconds or 0.0
        if self._on_event is not None:
            try:
                self._on_event(name, seconds)
            except Exception:
                pass
        return True

    def reset(self) -> None:
        """Clear the events (the post-warmup baseline); signatures stay."""
        with self._lock:
            self._events = []

    @property
    def events(self) -> list:
        """Step names of the events since :meth:`reset`, in order."""
        with self._lock:
            return [name for name, _ in self._events]

    @property
    def total(self) -> int:
        """Number of events since :meth:`reset`."""
        with self._lock:
            return len(self._events)

    def counts(self) -> dict:
        """Signatures seen per step name (resets do not clear them)."""
        out: dict = {}
        with self._lock:
            for name in self._seen.values():
                out[name] = out.get(name, 0) + 1
        return out

    def lifetime(self) -> tuple:
        """``(events, capture seconds)`` since construction, warmup and
        resets included: the gateway's monotone capture counters sum these
        over the fleet's engines, live and retired."""
        with self._lock:
            return len(self._seen), self._lifetime_secs

    def summary(self) -> dict:
        """Scalars: events since reset, their capture seconds, signatures."""
        with self._lock:
            return {
                "graph_captures": len(self._events),
                "capture_secs": round(sum(s or 0.0 for _, s in self._events), 6),
                "step_signatures": len(self._seen),
            }


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

    def merge(self, other: "PipelineStats") -> "PipelineStats":
        """Fold ``other``'s counters into this one (several loaders in one
        breakdown); returns ``self``."""
        with other._lock:
            wait, stage, depth = list(other._wait), list(other._stage), list(other._depth)
        with self._lock:
            for mine, theirs in ((self._wait, wait), (self._stage, stage)):
                mine[0] += theirs[0]
                mine[1] = max(mine[1], theirs[1])
                mine[2] = theirs[2] or mine[2]
                mine[3] += theirs[3]
            self._depth[0] += depth[0]
            self._depth[1] += depth[1]
        return self

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
                 pipeline_stats: Optional[PipelineStats] = None, device=None,
                 serving_stats=None, gateway_stats=None, tracer=None):
        self.kwargs = kwargs
        self.log_dir = log_dir or kwargs.output_trace_dir or DEFAULT_TRACE_DIR
        sched = kwargs.schedule_option or {}
        self.wait = int(sched.get("wait", 0)) + int(sched.get("skip_first", 0))
        self.warmup = int(sched.get("warmup", 0))
        self.active = int(sched.get("active", 0)) or None  # None = the whole block
        self.device = device
        self.pipeline_stats = pipeline_stats
        self.serving_stats = serving_stats
        self.gateway_stats = gateway_stats
        # An observability.Tracer: each step() emits a "train_step" span
        # in the serving engine's Chrome-trace format.
        self.tracer = tracer
        self.profiler = None
        self.trace_files: list[str] = []
        self._step = 0
        self._tracing = False
        self._step_breakdowns: list[dict] = []
        self._last_step_t: Optional[float] = None

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
        self._last_step_t = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._stop()
        return False

    def attach_pipeline_stats(self, stats: PipelineStats):
        """Attach input-pipeline counters so ``step()`` snapshots them."""
        self.pipeline_stats = stats
        return self

    def attach_serving_stats(self, stats):
        """Attach serving-engine counters (``serving.metrics.ServingStats``)
        so ``step()`` snapshots them under ``serving/`` keys."""
        self.serving_stats = stats
        return self

    def attach_gateway_stats(self, stats):
        """Attach HTTP gateway counters (``serving.metrics.GatewayStats``)
        so ``step()`` snapshots them under ``gateway/`` keys."""
        self.gateway_stats = stats
        return self

    def attach_tracer(self, tracer):
        """Attach an ``observability.Tracer`` so every ``step()`` emits a
        ``train_step`` span (step-to-step wall time, with the input
        pipeline's data-wait breakdown in ``args``)."""
        self.tracer = tracer
        self._last_step_t = time.monotonic()
        return self

    def step(self):
        """End a step: emit its span, snapshot the attached counters, then
        open or close the traced window as the schedule says."""
        if self.tracer is not None:
            now = time.monotonic()
            if self._last_step_t is not None:
                args: dict = {"step": self._step}
                if self.pipeline_stats is not None:
                    s = self.pipeline_stats.summary()
                    args["data_wait_ms"] = s["data_wait_ms_last"]
                    args["stage_ms"] = s["stage_ms_last"]
                self.tracer.emit("train_step", self._last_step_t, now - self._last_step_t,
                                 cat="training", args=args)
            self._last_step_t = now
        if (self.pipeline_stats is not None or self.serving_stats is not None
                or self.gateway_stats is not None):
            snap = {"step": self._step}
            if self.pipeline_stats is not None:
                snap.update(self.pipeline_stats.summary())
            if self.serving_stats is not None:
                snap.update({f"serving/{k}": v for k, v in self.serving_stats.summary().items()})
            if self.gateway_stats is not None:
                snap.update({f"gateway/{k}": v for k, v in self.gateway_stats.summary().items()})
            self._step_breakdowns.append(snap)
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

    def serving_breakdown(self) -> dict:
        """The serving engine's latest summary; empty without counters."""
        if self.serving_stats is None:
            return {}
        return self.serving_stats.summary()

    def gateway_breakdown(self) -> dict:
        """The gateway's latest summary; empty without counters."""
        if self.gateway_stats is None:
            return {}
        return self.gateway_stats.summary()

    @property
    def step_breakdowns(self) -> list[dict]:
        """One cumulative snapshot per ``step()``: the input pipeline's
        counters, the ``serving/``-prefixed engine counters and the
        ``gateway/``-prefixed gateway counters."""
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
