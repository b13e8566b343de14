"""Open-loop load generation for the serving gateway.

Counterpart of ``accelerate_tpu/loadgen`` (stdlib and numpy only, copied
so that the port imports nothing of the JAX package).

Closed-loop clients (send, wait, send again) cannot see queueing
collapse: when the server slows down, a closed-loop client slows its
own offered load to match, so latency looks flat right through
saturation. Real traffic is open-loop — arrivals keep coming whether
or not the server is keeping up — which is why serving claims here are
gated on this harness rather than on per-request benchmarks.

Three pieces, all stdlib + numpy:

* :class:`~.generator.ArrivalSchedule` — seeded heavy-tailed
  (lognormal / Pareto) or uniform inter-arrival times; offered load is
  a property OF THE SCHEDULE, fixed before the first byte is sent.
* :class:`~.generator.TrafficProfile` — heavy-tailed prompt/output
  lengths and a mixed adapter / sampling-seed / priority request mix.
* :func:`~.generator.run_open_loop` — tens of thousands of scheduled
  SSE streams driven from ONE asyncio client loop, each timestamped
  against its *scheduled* arrival (a stream the server couldn't even
  accept still counts against the tail — that is the open-loop point).

:func:`~.report.build_report` turns the raw per-stream results into
the JSON report consumed by ``chip_smoke.py`` (phase 4e) and the
``accelerate-tpu-torch loadtest`` CLI: goodput, p50/p99/p99.9 TTFT
and ITL, 429/Retry-After conformance, token-accounting balance, and
host CPU per stream.
"""

from .generator import (ArrivalSchedule, StreamResult, TrafficProfile,
                        fetch_gateway_metrics, run_open_loop)
from .report import build_report, percentile

__all__ = [
    "ArrivalSchedule",
    "TrafficProfile",
    "StreamResult",
    "run_open_loop",
    "fetch_gateway_metrics",
    "build_report",
    "percentile",
]
