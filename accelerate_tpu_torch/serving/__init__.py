"""The serving engine on one GPU: continuous batching over fixed-shape
steps captured as CUDA graphs.

Counterpart of ``accelerate_tpu/serving`` (ROADMAP A5, A6): the engine
(``engine.py``; its adapters and int8 base weights come from
``accelerate_tpu_torch.adapters``), its requests (``request.py``), the admission queue, slot
scheduler, page pool and prefix cache (``scheduler.py``), the traffic
classes (``control.py``, ``PriorityPolicy``), the counters (``metrics.py``)
and the graph runner (``graphs.py``, which has no JAX counterpart). The
gateway, the router, the fleet supervisor and chaos come with ROADMAP A7.
"""

from .control import DEFAULT_PRIORITY_CLASSES, PriorityPolicy
from .engine import ServingEngine
from .graphs import StepGraphs
from .metrics import HISTOGRAM_NAMES, LATENCY_BUCKETS_MS, LatencyHistogram, ServingStats
from .request import Request, RequestStatus
from .scheduler import AdmissionQueue, PagePool, PrefixCache, QueueClosed, QueueFull, SlotScheduler

__all__ = [
    "AdmissionQueue",
    "DEFAULT_PRIORITY_CLASSES",
    "HISTOGRAM_NAMES",
    "LATENCY_BUCKETS_MS",
    "LatencyHistogram",
    "PagePool",
    "PrefixCache",
    "PriorityPolicy",
    "QueueClosed",
    "QueueFull",
    "Request",
    "RequestStatus",
    "ServingEngine",
    "ServingStats",
    "SlotScheduler",
    "StepGraphs",
]
