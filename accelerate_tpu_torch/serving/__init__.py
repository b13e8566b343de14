"""Serving on one GPU: the engine over fixed-shape steps captured as CUDA
graphs, and the fleet in front of it.

Counterpart of ``accelerate_tpu/serving`` (ROADMAP A5-A7): the engine
(``engine.py``; its adapters and int8 base weights come from
``accelerate_tpu_torch.adapters``), its requests (``request.py``), the
admission queue, slot scheduler, page pool and prefix cache
(``scheduler.py``), the control plane (``control.py``: priority classes,
tenant rate limits, fair share, the autoscaler), the counters
(``metrics.py``), the graph runner (``graphs.py``, which has no JAX
counterpart), the replica router with failover (``router.py``), the
supervisor (``supervisor.py``), scripted faults (``chaos.py``) and the
HTTP gateway in both front ends (``gateway.py``, ``gateway_aio.py``), and
tensor-parallel slices (``mesh_exec.py``: one process per tp index, process
0 leading every slice; the engine's ``tp=``/``mesh=``, and
``ReplicaSet.from_mesh``).
"""

from .chaos import ChaosKilled, ChaosSchedule
from .control import (
    DEFAULT_PRIORITY_CLASSES,
    AutoscaleConfig,
    FairShareAdmission,
    FleetAutoscaler,
    PriorityPolicy,
    TenantRateLimiter,
    TokenBucket,
)
from .engine import ServingEngine
from .gateway import GatewayConfig, ServingGateway
from .graphs import StepGraphs
from .mesh_exec import SliceExec, SlicePlan
from .metrics import HISTOGRAM_NAMES, LATENCY_BUCKETS_MS, GatewayStats, LatencyHistogram, ServingStats
from .request import Request, RequestStatus
from .router import FleetRequest, ReplicaSet, ReplicaState
from .scheduler import AdmissionQueue, PagePool, PrefixCache, QueueClosed, QueueFull, SlotScheduler
from .supervisor import FleetSupervisor, HungReplicaError

__all__ = [
    "AdmissionQueue",
    "AutoscaleConfig",
    "ChaosKilled",
    "ChaosSchedule",
    "DEFAULT_PRIORITY_CLASSES",
    "FairShareAdmission",
    "FleetAutoscaler",
    "FleetRequest",
    "FleetSupervisor",
    "GatewayConfig",
    "GatewayStats",
    "HISTOGRAM_NAMES",
    "HungReplicaError",
    "LATENCY_BUCKETS_MS",
    "LatencyHistogram",
    "PagePool",
    "PrefixCache",
    "PriorityPolicy",
    "QueueClosed",
    "QueueFull",
    "ReplicaSet",
    "ReplicaState",
    "Request",
    "RequestStatus",
    "ServingEngine",
    "ServingGateway",
    "ServingStats",
    "SliceExec",
    "SlicePlan",
    "SlotScheduler",
    "StepGraphs",
    "TenantRateLimiter",
    "TokenBucket",
]
