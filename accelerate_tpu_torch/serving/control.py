"""SLO-aware fleet control plane: the POLICY layer over the serving
mechanisms the rest of this package provides.

Counterpart of ``accelerate_tpu/serving/control.py``, the same host-side
bookkeeping over the counters the engines publish, so no policy decision
can change a captured step. The four policies and the mechanisms they
drive:

* :class:`PriorityPolicy` — named traffic classes with a total order
  (``interactive`` ahead of ``standard`` ahead of ``batch`` by default).
  Two mechanisms consult it: the
  :class:`~.scheduler.AdmissionQueue` becomes a priority queue (FIFO
  *within* each class — interactive requests admit ahead of queued batch
  work), and the paged engine's pool-exhaustion preemption picks its
  victim policy-first (lowest class first, newest admitted within a
  class) instead of plain newest-admitted. Preempted streams resume
  token-exact through the existing prompt+tokens readmit path.
* :class:`TokenBucket` / :class:`TenantRateLimiter` — per-tenant request
  rate limits at the gateway, keyed on the adapter name (the tenant
  identity this stack already has). A refused request gets a structured
  429 whose ``Retry-After`` derives from the bucket's refill time,
  clamped through the gateway's shared ``[retry_after_s,
  retry_after_max_s]`` path like every other shed.
* :class:`FairShareAdmission` — weighted fair share over in-flight
  streams per tenant. Work-conserving: any tenant may borrow unused
  capacity while the fleet has headroom; once fleet occupancy crosses
  the pressure threshold, a tenant past its weighted share is shed (429)
  so under-share tenants keep finding room.
* :class:`AutoscaleConfig` / :class:`FleetAutoscaler` — a closed loop
  over the :class:`~.supervisor.FleetSupervisor`'s scan: when queue
  depth or projected page pressure outruns the observed
  ``page_drain_rate()``, a PARKED replica is rebuilt from its retained
  factory (``ReplicaSet.unpark_replica`` — the same machinery
  auto-restart uses); when the fleet idles below the low watermark for
  ``scale_down_idle_s``, the marginal replica drains and parks. Both
  directions respect hysteresis (``cooldown_s``) and never touch a
  CRASH_LOOP replica (scale-up only consumes PARKED replicas, scale-down
  only drains HEALTHY ones).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

__all__ = [
    "DEFAULT_PRIORITY_CLASSES",
    "PriorityPolicy",
    "TokenBucket",
    "TenantRateLimiter",
    "FairShareAdmission",
    "AutoscaleConfig",
    "FleetAutoscaler",
]

#: Highest-priority first. ``standard`` is the default class for requests
#: that carry no ``priority`` (and for unknown class names, so a typo'd
#: class degrades to normal service instead of starving or dominating).
DEFAULT_PRIORITY_CLASSES = ("interactive", "standard", "batch")


class PriorityPolicy:
    """A total order over named traffic classes.

    ``rank(name)`` maps a class name to its position (0 = most
    important); ``None`` and unknown names map to the default class, so
    priority-less traffic keeps exactly its pre-policy behavior — with
    every request unranked the priority queue degenerates to FIFO and
    victim selection degenerates to newest-admitted.
    """

    def __init__(self, classes: Sequence[str] = DEFAULT_PRIORITY_CLASSES,
                 default: Optional[str] = None):
        classes = tuple(classes)
        if not classes:
            raise ValueError("PriorityPolicy needs at least one class")
        if len(set(classes)) != len(classes):
            raise ValueError(f"duplicate priority class in {classes}")
        if default is None:
            default = ("standard" if "standard" in classes
                       else classes[len(classes) // 2])
        if default not in classes:
            raise ValueError(
                f"default class {default!r} not in classes {classes}")
        self.classes = classes
        self.default = default
        self._rank = {name: i for i, name in enumerate(classes)}
        self._default_rank = self._rank[default]

    def rank(self, priority: Optional[str]) -> int:
        """0 = most important; ``None``/unknown -> the default class."""
        if priority is None:
            return self._default_rank
        return self._rank.get(priority, self._default_rank)

    def __repr__(self):
        return (f"PriorityPolicy({'>'.join(self.classes)}, "
                f"default={self.default!r})")


class TokenBucket:
    """One tenant's refillable request budget (thread-safe).

    ``rate_per_s`` tokens refill per second up to ``burst`` capacity;
    each admitted request spends one. :meth:`retry_after` is the time
    until the next whole token refills — the honest ``Retry-After`` for
    a refusal (the caller clamps it into the gateway's bounds).
    """

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0 (got {rate_per_s})")
        self.rate_per_s = float(rate_per_s)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float):
        self._tokens = min(self.burst,
                           self._tokens + (now - self._stamp) * self.rate_per_s)
        self._stamp = now

    def try_acquire(self, now: Optional[float] = None) -> bool:
        """Spend one token if available."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def retry_after(self, now: Optional[float] = None) -> float:
        """Seconds until one whole token will have refilled."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.rate_per_s


class TenantRateLimiter:
    """Token buckets keyed on tenant (adapter name; base traffic is the
    ``"_base"`` tenant). ``limits`` maps tenant -> requests/s; the
    ``"*"`` key is a per-tenant default applied to any tenant without an
    explicit limit (no ``"*"`` -> unlisted tenants are unlimited).
    Bucket capacity is ``rate * burst_s`` (>= 1), so a tenant may burst
    that many seconds of its budget after idling."""

    def __init__(self, limits: dict, burst_s: float = 2.0):
        if burst_s <= 0:
            raise ValueError(f"burst_s must be > 0 (got {burst_s})")
        self.limits = {str(k): float(v) for k, v in dict(limits).items()}
        for tenant, rate in self.limits.items():
            if rate <= 0:
                raise ValueError(
                    f"rate limit for {tenant!r} must be > 0 (got {rate})")
        self.burst_s = float(burst_s)
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        rate = self.limits.get(tenant, self.limits.get("*"))
        if rate is None:
            return None
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(rate, rate * self.burst_s)
                self._buckets[tenant] = bucket
        return bucket

    def admit(self, tenant: str) -> Optional[float]:
        """None = admitted (token spent); else seconds until the bucket
        refills one token — the refusal's raw ``Retry-After``."""
        bucket = self._bucket(tenant)
        if bucket is None or bucket.try_acquire():
            return None
        return bucket.retry_after()


class FairShareAdmission:
    """Weighted fair share over concurrently in-flight streams.

    ``weights`` maps tenant -> weight (the ``"*"`` key sets the default
    weight for unlisted tenants, else 1.0). Admission is work-conserving:
    while total in-flight stays under ``pressure * capacity`` any tenant
    may borrow idle capacity freely; past that threshold a tenant is
    admitted only while under its guaranteed share
    ``max(1, weight / active_weight * capacity)`` (active_weight sums the
    weights of tenants currently holding streams, plus the applicant), so
    the reserved headroom is what keeps under-share tenants admissible at
    the moment an over-share tenant is shed.
    """

    def __init__(self, weights: dict, pressure: float = 0.85):
        if not 0.0 < pressure <= 1.0:
            raise ValueError(f"pressure must be in (0, 1] (got {pressure})")
        self.weights = {str(k): float(v) for k, v in dict(weights).items()}
        for tenant, w in self.weights.items():
            if w <= 0:
                raise ValueError(
                    f"fair-share weight for {tenant!r} must be > 0 (got {w})")
        self.pressure = float(pressure)
        self._inflight: dict[str, int] = {}
        self._lock = threading.Lock()
        self.sheds = 0

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.weights.get("*", 1.0))

    def inflight(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._inflight.get(tenant, 0)
            return sum(self._inflight.values())

    def guaranteed(self, tenant: str, capacity: int) -> int:
        """This tenant's reserved stream count at ``capacity``."""
        with self._lock:
            return self._guaranteed_locked(tenant, capacity)

    def _guaranteed_locked(self, tenant: str, capacity: int) -> int:
        active = set(self._inflight) | {tenant}
        total_w = sum(self.weight(t) for t in active)
        if total_w <= 0:
            return max(1, capacity)
        return max(1, int(self.weight(tenant) / total_w * capacity))

    def try_acquire(self, tenant: str, capacity: int) -> bool:
        """Admit one stream for ``tenant`` against ``capacity`` total
        fleet admission slots; the caller MUST :meth:`release` exactly
        once per successful acquire (the gateway wires this to the fleet
        request's done callback)."""
        capacity = max(1, int(capacity))
        with self._lock:
            mine = self._inflight.get(tenant, 0)
            total = sum(self._inflight.values())
            if (total + 1 > self.pressure * capacity
                    and mine + 1 > self._guaranteed_locked(tenant, capacity)):
                self.sheds += 1
                return False
            self._inflight[tenant] = mine + 1
            return True

    def release(self, tenant: str):
        with self._lock:
            n = self._inflight.get(tenant, 0) - 1
            if n > 0:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)


class AutoscaleConfig:
    """Knobs for the :class:`FleetAutoscaler` closed loop.

    Args:
      min_replicas: never drain below this many running (HEALTHY or
        mid-scale) replicas.
      max_replicas: never unpark above this many running replicas
        (``None`` = the fleet's total replica slots).
      scale_up_queue_depth: mean queued requests per running replica
        past which a scale-up fires (queue pressure signal).
      scale_up_wait_s: page-pressure horizon — scale up when the fleet's
        standing projected page deficit cannot drain within this many
        seconds at the observed ``page_drain_rate()`` (mirrors the
        gateway's shed rule, one level earlier).
      scale_down_idle_s: how long fleet occupancy must stay at or below
        ``idle_load`` (with empty queues) before the marginal replica
        begins draining — the down-direction half of the hysteresis.
      idle_load: busy-slot fraction at or below which the fleet counts
        as idle for scale-down purposes.
      cooldown_s: minimum seconds between any two scaling actions — the
        up-direction half of the hysteresis (a freshly spawned replica
        gets this long to absorb the backlog before the signal can fire
        again).
    """

    def __init__(self, *, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 scale_up_queue_depth: float = 4.0,
                 scale_up_wait_s: float = 5.0,
                 scale_down_idle_s: float = 10.0,
                 idle_load: float = 0.25,
                 cooldown_s: float = 5.0):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1 (got {min_replicas})")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        if scale_up_queue_depth <= 0 or scale_up_wait_s <= 0:
            raise ValueError(
                "scale_up_queue_depth and scale_up_wait_s must be > 0")
        if scale_down_idle_s < 0 or cooldown_s < 0:
            raise ValueError(
                "scale_down_idle_s and cooldown_s must be >= 0")
        if not 0.0 <= idle_load < 1.0:
            raise ValueError(f"idle_load must be in [0, 1) (got {idle_load})")
        self.min_replicas = int(min_replicas)
        self.max_replicas = max_replicas if max_replicas is None \
            else int(max_replicas)
        self.scale_up_queue_depth = float(scale_up_queue_depth)
        self.scale_up_wait_s = float(scale_up_wait_s)
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.idle_load = float(idle_load)
        self.cooldown_s = float(cooldown_s)


class FleetAutoscaler:
    """Closed-loop replica-count policy over a
    :class:`~.router.ReplicaSet`.

    Drive :meth:`step` periodically — attach it to a
    :class:`~.supervisor.FleetSupervisor` (``FleetSupervisor(fleet,
    autoscaler=...)`` folds a step into every watchdog scan) or call it
    from any loop. Each step does at most one scaling action:

    * **up** — when the queue-depth or page-pressure signal fires and a
      PARKED replica exists below ``max_replicas``, rebuild it from its
      retained factory (:meth:`~.router.ReplicaSet.unpark_replica` —
      full warmup, adapter registrations replayed). The build runs on
      the calling thread, exactly like a supervisor restart.
    * **down** — when the fleet has idled for ``scale_down_idle_s`` and
      more than ``min_replicas`` run, the highest-index idle HEALTHY
      replica starts DRAINING; a later step parks it once its last
      stream finishes (two-phase, so scale-down never drops tokens).

    CRASH_LOOP replicas are invisible to the loop by construction: they
    are neither PARKED (scale-up skips them) nor HEALTHY (scale-down
    skips them), so the circuit breaker's verdict stands until an
    operator intervenes.
    """

    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None,
                 flight_capacity: int = 256):
        from ..observability import FlightRecorder

        self.fleet = fleet
        self.config = config if config is not None else AutoscaleConfig()
        if (self.config.max_replicas is not None
                and self.config.max_replicas > len(fleet)):
            raise ValueError(
                f"max_replicas ({self.config.max_replicas}) exceeds the "
                f"fleet's replica slots ({len(fleet)}); add PARKED slots "
                "with ReplicaSet.add_parked first")
        self._flight = FlightRecorder(capacity=int(flight_capacity),
                                      name="autoscaler")
        self._lock = threading.Lock()
        self._idle_since: Optional[float] = None
        self._last_action_at = 0.0
        self._parking: set[int] = set()
        self.scale_ups = 0
        self.scale_downs = 0

    def events(self) -> list[dict]:
        """Flight-recorder events so far (oldest first): ``scale_up``,
        ``scale_down_drain``, ``scale_down_parked``, ``scale_up_failed``."""
        return self._flight.snapshot()

    # -- signals ----------------------------------------------------------
    def _survey(self):
        from .router import ReplicaState

        running, parked, draining = [], [], []
        for r in self.fleet.replicas:
            if r.state is ReplicaState.HEALTHY and r.engine is not None \
                    and r.engine.healthy:
                running.append(r)
            elif r.state is ReplicaState.PARKED:
                parked.append(r)
            elif r.state is ReplicaState.DRAINING:
                draining.append(r)
        return running, parked, draining

    def _pressure(self, running) -> Optional[str]:
        """The scale-up signal, as a reason string (None = no pressure)."""
        cfg = self.config
        if not running:
            return None
        queued = sum(len(r.engine._queue) for r in running)
        if queued / len(running) >= cfg.scale_up_queue_depth:
            return f"queue_depth ({queued} queued / {len(running)} replicas)"
        # Page pressure, the gateway's shed rule one level earlier: the
        # standing deficit (admitted + queued demand past pool headroom)
        # will not drain within the horizon at the observed rate.
        deficit = min((r.engine.projected_page_deficit(0) for r in running),
                      default=0)
        if deficit > 0:
            rate = self.fleet.page_drain_rate()
            if rate <= 0 or deficit > rate * cfg.scale_up_wait_s:
                return f"page_pressure (deficit {deficit}, drain {rate:.2f}/s)"
        return None

    @staticmethod
    def _is_idle(replica) -> bool:
        e = replica.engine
        return (e is not None and e.free_slots == e.max_slots
                and len(e._queue) == 0)

    # -- the loop body ----------------------------------------------------
    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One policy decision; returns the action taken (``"up"``,
        ``"down"``, ``"parked"``) or None. Safe to call concurrently with
        traffic; serialized internally."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        with self._lock:
            running, parked, draining = self._survey()
            # Phase 2 of any in-flight scale-down: park the drained
            # replica once its last stream finished.
            for r in draining:
                if r.index in self._parking and self._is_idle(r):
                    self.fleet.park_replica(r.index)
                    self._parking.discard(r.index)
                    self.scale_downs += 1
                    self._flight.record("scale_down_parked", replica=r.index)
                    return "parked"
            in_cooldown = now - self._last_action_at < cfg.cooldown_s
            reason = self._pressure(running)
            if reason is not None:
                self._idle_since = None
                max_replicas = (len(self.fleet) if cfg.max_replicas is None
                                else cfg.max_replicas)
                if in_cooldown or not parked \
                        or len(running) + len(draining) >= max_replicas:
                    return None
                target = parked[0]
                try:
                    self.fleet.unpark_replica(target.index)
                except Exception as e:  # noqa: BLE001 - a failed build must not kill the scan
                    self._flight.record("scale_up_failed",
                                        replica=target.index, error=repr(e))
                    self._last_action_at = now  # back off a cooldown
                    return None
                self.scale_ups += 1
                self._last_action_at = now
                self._flight.record("scale_up", replica=target.index,
                                    reason=reason)
                return "up"
            # Down direction: sustained idleness, then drain the marginal
            # replica (phase 1 — a later step parks it once empty).
            idle = (running
                    and all((r.engine.max_slots - r.engine.free_slots)
                            / r.engine.max_slots <= cfg.idle_load
                            for r in running)
                    and all(len(r.engine._queue) == 0 for r in running))
            if not idle:
                self._idle_since = None
                return None
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since < cfg.scale_down_idle_s
                    or in_cooldown):
                return None
            if len(running) + len(draining) <= cfg.min_replicas:
                return None
            target = max(running, key=lambda r: r.index)
            self.fleet.drain_replica(target.index)
            self._parking.add(target.index)
            self._last_action_at = now
            self._flight.record("scale_down_drain", replica=target.index)
            return "down"
