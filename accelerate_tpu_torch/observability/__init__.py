"""Request-scoped spans and the serving engine's flight recorder.

Counterpart of ``accelerate_tpu/observability`` (``tracing.py`` and
``flight_recorder.py``; the Prometheus linter comes with the gateway). The
graph-capture counterpart of ``CompileWatcher``, ``GraphCaptureWatcher``,
lives in :mod:`accelerate_tpu_torch.utils.profiling`.
"""

from .flight_recorder import FlightRecorder
from .tracing import (
    Tracer,
    TraceSpan,
    clean_trace_id,
    merge_chrome_traces,
    new_trace_id,
    validate_chrome_trace,
)

__all__ = [
    "FlightRecorder",
    "Tracer",
    "TraceSpan",
    "clean_trace_id",
    "merge_chrome_traces",
    "new_trace_id",
    "validate_chrome_trace",
]
