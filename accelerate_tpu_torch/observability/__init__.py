"""Request-scoped spans, the serving engine's flight recorder, and the
Prometheus linter.

Counterpart of ``accelerate_tpu/observability``: ``tracing.py``,
``flight_recorder.py`` and ``promlint.py`` (the text-exposition linter the
gateway's ``/metrics`` is held to). The graph-capture counterpart of
``CompileWatcher``, ``GraphCaptureWatcher``, lives in
:mod:`accelerate_tpu_torch.utils.profiling`.
"""

from .flight_recorder import FlightRecorder
from .promlint import lint_prometheus_text, parse_sample_line
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
    "lint_prometheus_text",
    "parse_sample_line",
    "Tracer",
    "TraceSpan",
    "clean_trace_id",
    "merge_chrome_traces",
    "new_trace_id",
    "validate_chrome_trace",
]
