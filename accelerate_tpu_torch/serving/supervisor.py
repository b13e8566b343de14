"""The self-healing control loop over a :class:`~.router.ReplicaSet`.

Counterpart of ``accelerate_tpu/serving/supervisor.py``. The router's
health model is LAZY: a replica is fenced when a routing decision notices
``engine.error`` is set. That catches clean deaths but not the two
failure modes that dominate real fleets — a replica that *hangs* (a graph
replay that never returns leaves ``error`` None forever) and a fleet that permanently SHRINKS because nothing ever
rebuilds a fenced replica. :class:`FleetSupervisor` is the monitor
thread that closes both gaps, built entirely on the recovery primitives
the router already has (token-exact failover, retained engine
factories):

* **Heartbeat watchdog** — every engine publishes ``(loop_iters,
  wall_time)`` from the top of its run loop. A replica whose heartbeat
  stalls past ``hang_timeout_s`` while ``error`` is still None is HUNG:
  the supervisor fences it, kills the engine (a loop that is merely
  suppressed dies through the normal fatal path and fails its requests
  over token-exact), and — if the thread is truly wedged past
  ``kill_grace_s`` — force-retires its in-flight and queued requests so
  they fail over anyway. Exactly-once token emission survives even an
  abandoned engine that later unwedges (the router drops stale-flight
  tokens).
* **Auto-restart** — a FAILED replica with a retained factory is rebuilt
  through :meth:`~.router.ReplicaSet.restart_replica` (fresh engine,
  full warmup capturing its graphs, adapter registrations replayed) and
  rejoins HEALTHY, with exponential backoff between attempts.
* **Circuit breaker** — ``max_restarts`` attempts within
  ``restart_window_s`` trips the breaker: the replica parks in
  CRASH_LOOP and the supervisor stops burning the card on it until an
  operator calls :meth:`~.router.ReplicaSet.reset_circuit`.
* **Autoscaling clock** — pass an ``autoscaler``
  (:class:`~.control.FleetAutoscaler`) and each scan ends by stepping
  it: replicas spawn from retained factories under sustained pressure
  and drain/park back down when idle, on the same thread that just
  fenced and restarted, so scale decisions never race recovery.

Every decision lands in the supervisor's own flight recorder (and, via
the router's counters, in ``fleet_metrics()`` → Prometheus
``/metrics``): ``hang_fence``, ``restart``, ``restart_failed``,
``circuit_open``, ``force_retire``.

Use as a context manager or ``start()``/``stop()``::

    fleet = ReplicaSet.from_factory(make_engine, 3)
    with FleetSupervisor(fleet, hang_timeout_s=2.0):
        ...  # serve; replicas now heal themselves

Deterministic fault injection for all of this lives in :mod:`~.chaos`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from ..observability import FlightRecorder, Tracer
from .request import RequestStatus
from .router import ReplicaSet, ReplicaState

__all__ = ["FleetSupervisor", "HungReplicaError"]


class HungReplicaError(RuntimeError):
    """Injected into a replica the watchdog fenced on heartbeat stall —
    distinguishes liveness fences from real engine errors in postmortems
    and failover reports."""


class _ReplicaWatch:
    """Supervisor-private per-replica restart bookkeeping."""

    def __init__(self, backoff_s: float):
        self.attempts: collections.deque = collections.deque()  # wall times
        self.backoff_s = backoff_s
        self.next_attempt_at = 0.0
        self.hang_handled = False  # current hang already fenced/killed


class FleetSupervisor:
    """Watchdog + auto-restart + circuit breaker for a
    :class:`~.router.ReplicaSet`.

    Args:
      replica_set: the fleet to supervise.
      poll_interval_s: watchdog scan period. Each scan is a few dozen
        host reads — 20 Hz costs nothing next to decode ticks.
      hang_timeout_s: heartbeat silence that declares a live, error-less
        engine HUNG. Must comfortably exceed the engine's worst-case
        loop iteration (a full prefill chunk + decode tick), or slow
        ticks get fenced as hangs.
      kill_grace_s: after killing a hung engine, how long to wait for
        its thread to die through the normal fatal path before
        force-retiring its requests (the thread is abandoned; it is a
        daemon and its late tokens are dropped by the router).
      restart: rebuild FAILED replicas that have a factory (True) or
        only watch for hangs (False).
      restart_backoff_s / restart_backoff_max_s: exponential backoff
        between restart attempts on one replica (doubles per failed
        attempt, resets on success).
      max_restarts / restart_window_s: the circuit breaker — more than
        ``max_restarts`` attempts within ``restart_window_s`` parks the
        replica in CRASH_LOOP instead of trying again.
      flight_capacity: events kept in the supervisor's flight recorder.
      tracing: emit supervisor spans (fence/restart) into a tracer ring.
      autoscaler: an optional :class:`~.control.FleetAutoscaler` stepped
        once per scan AFTER health/restart handling — the supervisor
        thread is the autoscale control loop's clock, so scale decisions
        always see post-fence state and never race a restart.
    """

    def __init__(self, replica_set: ReplicaSet, *,
                 poll_interval_s: float = 0.05,
                 hang_timeout_s: float = 5.0,
                 kill_grace_s: float = 2.0,
                 restart: bool = True,
                 restart_backoff_s: float = 0.25,
                 restart_backoff_max_s: float = 30.0,
                 max_restarts: int = 3,
                 restart_window_s: float = 60.0,
                 flight_capacity: int = 256,
                 tracing: bool = True,
                 autoscaler=None):
        if hang_timeout_s <= 0 or poll_interval_s <= 0:
            raise ValueError("hang_timeout_s and poll_interval_s must be > 0")
        if max_restarts < 1:
            raise ValueError(f"max_restarts must be >= 1 (got {max_restarts})")
        self.fleet = replica_set
        self._poll_s = float(poll_interval_s)
        self._hang_timeout_s = float(hang_timeout_s)
        self._kill_grace_s = float(kill_grace_s)
        self._restart = bool(restart)
        self._backoff_s = float(restart_backoff_s)
        self._backoff_max_s = float(restart_backoff_max_s)
        self._max_restarts = int(max_restarts)
        self._window_s = float(restart_window_s)

        if (autoscaler is not None
                and getattr(autoscaler, "fleet", None) is not replica_set):
            raise ValueError(
                "autoscaler is bound to a different ReplicaSet than the "
                "one this supervisor watches")
        self._autoscaler = autoscaler
        self._watch = {r.index: _ReplicaWatch(self._backoff_s)
                       for r in replica_set.replicas}
        self._tracer = Tracer(capacity=1024, enabled=bool(tracing),
                              name="supervisor")
        self._flight = FlightRecorder(capacity=int(flight_capacity),
                                      name="supervisor", tracer=self._tracer)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # Supervisor-local counters (the fleet-level mirrors live on the
        # ReplicaSet so /metrics sees them even without a supervisor).
        self.hang_fences = 0
        self.restarts = 0
        self.restarts_failed = 0
        self.breaker_trips = 0
        self.force_retired = 0

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Spawn the watchdog thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-supervisor", daemon=True)
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0):
        """Stop the watchdog thread; in-flight restart attempts finish."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- observability ---------------------------------------------------
    @property
    def flight_recorder(self) -> FlightRecorder:
        """The supervisor's black box: ``hang_fence`` / ``restart`` /
        ``restart_failed`` / ``circuit_open`` / ``force_retire`` events
        with replica indices and timings."""
        return self._flight

    def events(self) -> list[dict]:
        """Flight-recorder events so far (oldest first)."""
        return self._flight.snapshot()

    # -- the control loop ------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception as e:  # a bad scan must not kill the watchdog
                self._flight.record("supervisor_error", error=repr(e))
            self._stop.wait(self._poll_s)

    def check_once(self):
        """One watchdog scan over every replica (public so tests and
        operators can drive the control loop synchronously)."""
        fleet = self.fleet
        fleet.refresh_health()  # fence clean deaths before classifying
        now = time.monotonic()
        for replica in fleet.replicas:
            state = replica.state
            if state in (ReplicaState.HEALTHY, ReplicaState.DRAINING):
                self._check_hang(replica, now)
            elif state is ReplicaState.FAILED and self._restart:
                self._maybe_restart(replica, now)
        if self._autoscaler is not None:
            self._autoscaler.step(now)

    # -- watchdog --------------------------------------------------------
    def _watch_for(self, replica) -> _ReplicaWatch:
        """Per-replica watch, created lazily: replicas added after init
        (``ReplicaSet.add_parked`` autoscale headroom) get one on first
        contact instead of KeyError-ing the scan."""
        return self._watch.setdefault(replica.index,
                                      _ReplicaWatch(self._backoff_s))

    def _check_hang(self, replica, now: float):
        engine = replica.engine
        watch = self._watch_for(replica)
        if not engine.running or engine.error is not None:
            return  # dead/dying: refresh_health's jurisdiction, not ours
        _, beat_wall = engine.heartbeat
        stalled_s = now - beat_wall
        if stalled_s <= self._hang_timeout_s:
            watch.hang_handled = False
            return
        if watch.hang_handled:
            return
        watch.hang_handled = True
        err = HungReplicaError(
            f"replica {replica.index} heartbeat stalled {stalled_s:.2f}s "
            f"(> hang_timeout {self._hang_timeout_s:g}s) with no engine "
            "error — fenced by watchdog")
        self._flight.record("hang_fence", replica=replica.index,
                            stalled_s=round(stalled_s, 3))
        with self._lock:
            self.hang_fences += 1
        self.fleet._note_hang_fence()
        # Fence FIRST so no new work routes there, then kill: a loop that
        # is alive-but-suppressed raises the injection at its next
        # iteration and retires everything through the normal fatal path
        # — requests fail over token-exact with no supervisor help.
        self.fleet._fence(replica)
        engine.kill(err)
        deadline = now + self._kill_grace_s
        while engine.running and time.monotonic() < deadline:
            time.sleep(min(0.01, self._poll_s))
        if engine.running and engine.error is None:
            # Truly wedged (e.g. a replay that never returned): the
            # loop will never see the injection. Mark the engine errored
            # and fail its requests over ourselves. The thread is a
            # daemon; if it ever unwedges, its retires no-op (requests
            # are terminal) and its tokens are dropped as stale flights.
            engine._error = err
            self._force_retire(replica, err)

    def _force_retire(self, replica, err):
        engine = replica.engine
        retired = 0
        try:
            active = [req for _, req in list(engine._slots._occupant.items())]
        except RuntimeError:  # dict mutated mid-iteration: engine not wedged
            active = []
        for req in active:
            req._finish(RequestStatus.FAILED, err)
            retired += 1
        try:
            queued = engine._queue.drain()
        except Exception:
            queued = []
        for req in queued:
            req._finish(RequestStatus.FAILED, err)
            retired += 1
        with self._lock:
            self.force_retired += retired
        self._flight.record("force_retire", replica=replica.index,
                            requests=retired)

    # -- auto-restart + breaker ------------------------------------------
    def _maybe_restart(self, replica, now: float):
        if self.fleet._factories[replica.index] is None:
            return  # nothing to rebuild from
        watch = self._watch_for(replica)
        if now < watch.next_attempt_at:
            return
        while watch.attempts and now - watch.attempts[0] > self._window_s:
            watch.attempts.popleft()
        if len(watch.attempts) >= self._max_restarts:
            self._flight.record("circuit_open", replica=replica.index,
                                attempts=len(watch.attempts),
                                window_s=self._window_s)
            with self._lock:
                self.breaker_trips += 1
            self.fleet.trip_breaker(replica.index)
            return
        watch.attempts.append(now)
        t0 = time.monotonic()
        try:
            self.fleet.restart_replica(replica.index,
                                       join_timeout=self._kill_grace_s)
        except Exception as e:
            with self._lock:
                self.restarts_failed += 1
            watch.backoff_s = min(watch.backoff_s * 2, self._backoff_max_s)
            watch.next_attempt_at = time.monotonic() + watch.backoff_s
            self._flight.record("restart_failed", replica=replica.index,
                                error=repr(e),
                                next_backoff_s=round(watch.backoff_s, 3))
            return
        with self._lock:
            self.restarts += 1
        watch.backoff_s = self._backoff_s
        watch.next_attempt_at = 0.0
        watch.hang_handled = False
        self._flight.record("restart", replica=replica.index,
                            warmup_s=round(time.monotonic() - t0, 3),
                            attempt=len(watch.attempts))

    def __repr__(self):
        return (f"FleetSupervisor(replicas={len(self.fleet)}, "
                f"running={self.running}, hang_fences={self.hang_fences}, "
                f"restarts={self.restarts}, trips={self.breaker_trips})")
