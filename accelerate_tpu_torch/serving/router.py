"""Multi-replica routing and fault-tolerant failover over serving engines.

Counterpart of ``accelerate_tpu/serving/router.py``. One
:class:`~.engine.ServingEngine` is both a capacity ceiling and a single
point of failure: its fixed ``[max_slots, max_len]`` decode state bounds
concurrency, and its single engine thread dying fails every in-flight
stream. The :class:`ReplicaSet` puts N independently failing engine
replicas behind one submit surface. On one card the replicas share the
model's weights (``from_factory`` builds every engine over the same
module); each keeps its own stream, page pool, graph pools and slot rows:

* **Routing** — least-loaded, cache-aware: a new request goes to the
  healthy replica with a free slot and the longest prefix-cache hit for
  its prompt, then most free decode slots (ties broken by total
  occupancy ``engine.load``, page headroom, then index). When the best
  replica's admission queue is full the next one is tried; only when
  EVERY healthy replica is saturated does the router surface
  :class:`~.scheduler.QueueFull` — the signal the gateway maps to
  HTTP 429.
* **Health** — per-replica :class:`ReplicaState`:
  HEALTHY (in rotation) → DRAINING (out of rotation, finishing its
  streams — operator-initiated via :meth:`ReplicaSet.drain_replica`) →
  FAILED (fenced). Health is refreshed lazily on every routing decision
  and metrics read — an engine whose run loop recorded a fatal error is
  demoted without any monitor thread. A
  :class:`~.supervisor.FleetSupervisor` layers ACTIVE health on top:
  heartbeat-watchdog fencing of hung (error-less) replicas, factory
  rebuilds of FAILED ones (RESTARTING → HEALTHY via
  :meth:`ReplicaSet.restart_replica`), and a circuit breaker parking a
  replica that keeps dying in CRASH_LOOP.
* **Failover** — a replica whose run loop raises fails every request it
  held (the engine's own cleanup path). The router hooks each request's
  terminal transition: when the cause of death was the ENGINE (not the
  request), the replica is fenced and the request is resubmitted to a
  healthy replica as ``prompt + tokens_emitted_so_far``, so the stream
  RESUMES — no token is re-emitted, none is lost. Re-prefilling the
  grown prompt is exactly the work the chunk-aligned prefix cache makes
  cheap. For greedy decoding the resumed stream is token-identical to an
  uninterrupted one (prefill's first-token selection at position
  ``len - 1`` is the same computation as the decode step there). A
  sampled draw is keyed by the request's seed and the token's position,
  so a seeded sampled stream resumes with the draws it would have made.

The caller-facing handle is a :class:`FleetRequest`: it survives
failovers (accumulating tokens across however many inner
:class:`~.request.Request` flights it takes) while mirroring the Request
API — ``tokens``, ``wait``, ``result``, ``output_ids``, ``cancel``.

A dead engine's device memory (pool, graph pools, slot rows) returns to
the allocator when nothing references the engine any more: the router
keeps no engine in its callbacks, requests or reports, and
:meth:`ReplicaSet.restart_replica` drops the dead one once its
replacement is swapped in. An engine whose thread was abandoned on a wedge
(its join timed out) keeps its memory for as long as the thread lives.

``ReplicaSet.from_mesh`` builds a fleet of tensor-parallel slices
(``mesh_exec.py``): one engine a slice, one fleet-shared host
``PrefixCache``, per-slice rebuild factories. Above ``tp=1`` every process
of the group builds the same fleet: process 0's is the fleet (router,
failover, supervisor, gateway above it), every other process's holds the
slices' followers, which a thread a slice rebuilds when the leader's
factory rebuilds that slice (on the same devices, its device group renewed)
and ends when the leader's fleet shuts down.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..observability import new_trace_id
from .engine import ServingEngine
from .mesh_exec import BUILD, CLOSE
from .metrics import ServingStats
from .request import Request, RequestStatus
from .scheduler import QueueFull

__all__ = ["ReplicaSet", "ReplicaState", "FleetRequest"]


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"         # in rotation, taking new requests
    DRAINING = "draining"       # out of rotation, finishing in-flight streams
    FAILED = "failed"           # fenced: run loop died or operator killed it
    RESTARTING = "restarting"   # fenced, replacement engine being built
    CRASH_LOOP = "crash_loop"   # circuit open: too many restarts in a window
    PARKED = "parked"           # scaled down: engine released, factory kept


class _Replica:
    """One engine plus its routing state (router internals). A PARKED
    replica holds NO engine (``engine is None``) — only its retained
    factory, from which :meth:`ReplicaSet.unpark_replica` rebuilds it."""

    def __init__(self, index: int, engine: Optional[ServingEngine]):
        self.index = index
        self.engine = engine
        self.state = ReplicaState.HEALTHY
        self.failures = 0  # requests this replica failed over FROM
        self.restarts = 0  # successful engine rebuilds (supervisor)

    def __repr__(self):
        free = self.engine.free_slots if self.engine is not None else "-"
        return (f"_Replica({self.index}, {self.state.value}, "
                f"free={free})")


class FleetRequest:
    """Router-level handle for one generation, stable across failovers.

    Tokens stream into :attr:`tokens` (and through ``on_token``) exactly
    once each, no matter how many replicas the request visits; the
    per-flight inner :class:`~.request.Request` objects are an
    implementation detail. The per-request deadline is GLOBAL — time
    spent on a replica that later died still counts against ``timeout``.
    """

    def __init__(self, prompt_ids, max_new_tokens: int = 20,
                 rng=None, seed: Optional[int] = None,
                 timeout: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 ignore_eos: bool = False,
                 adapter: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 priority: Optional[str] = None):
        # Reuse Request's prompt validation (shape + max_new bounds +
        # adapter/trace id/priority form).
        proto = Request(prompt_ids, max_new_tokens=max_new_tokens,
                        adapter=adapter, trace_id=trace_id,
                        priority=priority)
        self.prompt_ids = proto.prompt_ids
        self.max_new_tokens = proto.max_new_tokens
        self.rng = rng
        self.seed = seed
        self.timeout = timeout
        self.on_token = on_token
        self.ignore_eos = ignore_eos
        #: named LoRA adapter, preserved across failovers (None = base).
        self.adapter = proto.adapter
        #: traffic class, preserved across failovers (acted on by each
        #: engine's priority policy: queue order + preemption victims).
        self.priority = proto.priority
        #: correlation id shared by every flight this request takes —
        #: minted here (when the gateway didn't) so the spans a failover
        #: leaves on replica A and the resumed spans on replica B carry
        #: the SAME id and merge into one timeline.
        self.trace_id = proto.trace_id or new_trace_id()

        self.tokens: list[int] = []
        self.status = RequestStatus.QUEUED
        self.error: Optional[BaseException] = None
        #: replica indices this request ran on, in order (one entry when no
        #: failover happened; the failover test asserts on its length).
        self.replica_trail: list[int] = []

        self.submitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None

        self._cancel_requested = False
        self._done = threading.Event()
        self._done_callbacks: list[Callable[["FleetRequest"], None]] = []
        self._lock = threading.Lock()
        self._inner: Optional[Request] = None
        #: the most recently BUILT inner flight — the only one whose
        #: tokens may reach :meth:`_emit_from`. Normally identical to
        #: ``_inner``; it diverges exactly when a hung engine was
        #: force-retired by the supervisor and later unwedged: its stale
        #: flight keeps committing tokens, and this guard is what keeps
        #: them out of a stream that already resumed elsewhere.
        self._flight: Optional[Request] = None

    # -- caller API (mirrors Request) -----------------------------------
    def cancel(self):
        """Cancel the current flight; honored at the owning engine's next
        scheduler pass, and suppresses any further failover."""
        self._cancel_requested = True
        with self._lock:
            inner = self._inner
        if inner is not None:
            inner.cancel()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def failovers(self) -> int:
        """How many times this request was resubmitted after a replica
        died (0 for an uninterrupted stream)."""
        return max(0, len(self.replica_trail) - 1)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def add_done_callback(self, fn: Callable[["FleetRequest"], None]):
        """Call ``fn(self)`` exactly once when the request reaches a
        terminal status — immediately (on the caller's thread) if it is
        already done, otherwise from whichever engine/router thread drives
        the terminal transition. This is the completion signal an event-
        loop front end bridges onto (``loop.call_soon_threadsafe``)
        instead of parking a thread in :meth:`wait`; callbacks must not
        block. Exceptions propagate to the finishing thread, so keep the
        callback a pure notification."""
        with self._lock:
            if not self._done.is_set():
                self._done_callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Generated token ids [n] (prompt excluded), blocking until done;
        same error contract as :meth:`Request.result`."""
        if not self._done.wait(timeout):
            raise TimeoutError("request still in flight")
        if self.status != RequestStatus.COMPLETED:
            raise RuntimeError(
                f"request {self.status.value}"
                + (f": {self.error}" if self.error is not None else "")
            ) from self.error
        return np.asarray(self.tokens, np.int32)

    def output_ids(self, timeout: Optional[float] = None) -> np.ndarray:
        """[1, S + n] prompt + completion — the offline ``generate`` shape."""
        toks = self.result(timeout)
        return np.concatenate([self.prompt_ids, toks[None, :]], axis=1)

    # -- router internals ------------------------------------------------
    def _emit_from(self, inner: "Request", token: int):
        """Inner on_token trampoline: runs on whichever engine thread owns
        the current flight. Tokens from a STALE flight (an abandoned hung
        engine still committing after its requests were failed over) are
        dropped — exactly-once emission must hold across force-retires
        too. Callback exceptions propagate so the engine applies its
        normal isolation (fail THIS request only)."""
        if self._flight is not inner:
            return
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.tokens.append(token)
        if self.on_token is not None:
            self.on_token(token)

    def _remaining_new_tokens(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def _remaining_timeout(self, now: Optional[float] = None) -> Optional[float]:
        if self.timeout is None:
            return None
        now = time.monotonic() if now is None else now
        return self.submitted_at + self.timeout - now

    def _resume_prompt(self) -> np.ndarray:
        """``prompt + tokens_emitted_so_far`` — the failover prompt whose
        re-prefill resumes the stream with zero duplicated tokens."""
        if not self.tokens:
            return self.prompt_ids
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.tokens, np.int32)[None, :]],
            axis=1)

    def _finish(self, status: RequestStatus,
                error: Optional[BaseException] = None):
        with self._lock:
            if self._done.is_set():  # first terminal transition wins
                return
            self.status = status
            self.error = error
            self.finished_at = time.monotonic()
            self._done.set()
            callbacks, self._done_callbacks = self._done_callbacks, []
        for fn in callbacks:  # outside the lock: fn may re-enter this object
            fn(self)

    def __repr__(self):
        return (f"FleetRequest(S={self.prompt_ids.shape[1]}, "
                f"max_new={self.max_new_tokens}, status={self.status.value}, "
                f"tokens={len(self.tokens)}, trail={self.replica_trail})")


class ReplicaSet:
    """N serving-engine replicas behind one submit surface.

    Args:
      engines: the replicas (already constructed — replicas may differ in
        placement but MUST share model, sampling config, and eos id, or
        failover would change the distribution mid-stream).
      failover_block_s: how long a failover resubmission may block waiting
        for queue space on a healthy-but-saturated replica before the
        request is failed outright. The wait runs on the dead engine's
        exiting thread, so it only delays that replica's remaining
        cleanup, never live traffic.
      max_failovers: per-request cap on resubmissions (default: one per
        OTHER replica) — a request that somehow keeps landing on dying
        replicas fails instead of bouncing forever.

    Use as a context manager, or call :meth:`shutdown`.
    """

    def __init__(self, engines: Sequence[ServingEngine], *,
                 failover_block_s: float = 5.0,
                 max_failovers: Optional[int] = None,
                 factories: Optional[Sequence[Optional[Callable]]] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        eos = {e.eos_token_id for e in engines}
        samp = {e._sampling for e in engines}
        if len(eos) > 1 or len(samp) > 1:
            raise ValueError(
                "replicas disagree on sampling config or eos id — failover "
                f"would change the stream's distribution (eos={eos})")
        # Captured fleet-wide config: a parked replica has no engine to
        # read these from, and unpark validates rebuilds against them.
        self._eos = engines[0].eos_token_id
        self._sampling = engines[0]._sampling
        self._replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self._failover_block_s = float(failover_block_s)
        self._max_failovers = (len(engines) - 1 if max_failovers is None
                               else int(max_failovers))
        # Per-replica zero-arg engine builders (None = this replica cannot
        # be rebuilt). from_factory fills these in; a supervisor
        # uses them through restart_replica to return FAILED replicas to
        # rotation.
        if factories is None:
            self._factories: list[Optional[Callable]] = [None] * len(engines)
        else:
            self._factories = list(factories)
            if len(self._factories) != len(engines):
                raise ValueError(
                    f"factories must match engines 1:1 "
                    f"(got {len(self._factories)} for {len(engines)})")
        # name -> (adapter, kwargs), in registration order — replayed onto
        # a rebuilt replica's bank so restarts stay tenant-preserving.
        self._adapter_registry: dict = {}
        # Counters folded out of engines that were replaced: merged_stats
        # adds this in so fleet totals stay MONOTONE across restarts; the
        # same for their graph captures (capture_totals).
        self._retired_stats = ServingStats()
        self._retired_captures = (0, 0.0)
        self._lock = threading.Lock()
        self._submitted = 0
        self._failovers = 0      # fence-and-resubmit events (per request)
        self._fences = 0         # replicas demoted to FAILED
        self._failover_failed = 0  # resubmissions that found no home
        self._restarts = 0       # replicas rebuilt back to HEALTHY
        self._hang_fences = 0    # fences on heartbeat stall (watchdog)
        self._crash_loops = 0    # circuit-breaker trips to CRASH_LOOP
        self._scale_ups = 0      # replicas unparked back into rotation
        self._scale_downs = 0    # replicas parked (engine released)
        # Bounded postmortem log: one entry per failover hop, carrying
        # the dead replica's flight-recorder dump (see failover_reports).
        self._failover_reports: list[dict] = []
        #: a fleet of slices (from_mesh): the plan, each slice's mesh, and
        #: whether this process holds the fleet (process 0) or followers.
        self.slice_plan = None
        self._slice_meshes: list = []
        self.leader = True
        self._follower_threads: list = []
        self._closed_slices = False

    @classmethod
    def from_factory(cls, factory: Callable[[], ServingEngine],
                     num_replicas: int, **kwargs) -> "ReplicaSet":
        """Build ``num_replicas`` engines by calling ``factory()`` that
        many times (each call constructs an independent engine over the
        SAME model: the factory must not copy or cast the weights, so the
        replicas share one copy on the card). The factory is RETAINED per
        replica, so a :class:`~.supervisor.FleetSupervisor` can rebuild a
        dead replica from it."""
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1 (got {num_replicas})")
        return cls([factory() for _ in range(num_replicas)],
                   factories=[factory] * num_replicas, **kwargs)

    @classmethod
    def from_mesh(cls, model, *, tp: int, num_slices: Optional[int] = None, devices=None,
                  make_adapters: Optional[Callable] = None, share_prefix_cache: bool = True,
                  failover_block_s: float = 5.0, max_failovers: Optional[int] = None,
                  **engine_kwargs) -> "ReplicaSet":
        """A fleet of tensor-parallel slices (JAX ``:358-413``): carve the
        devices (default every visible card; ``["cpu"] * tp * num_slices``
        under ``device="cpu"``) into ``num_slices`` disjoint ``tp``-wide
        slices (every full slice by default) and build one sliced
        :class:`~.engine.ServingEngine` a slice. Routing, health, adapter
        affinity and token-exact failover are the existing machinery.

        Every slice shares ONE :class:`~.scheduler.PrefixCache` of host
        blocks (unless ``share_prefix_cache=False``), so a prefix prefilled
        on a slice that later dies is still a hit when its requests resume
        on another. ``make_adapters`` is called once a slice: a bank is
        placed on its slice and cannot serve another. A rebuilt slice gets
        the same devices and groups, a fresh bank and the shared cache.

        Above ``tp=1`` every process of the group calls this with the same
        arguments: process 0 gets the fleet, every other process one whose
        ``leader`` is False, holding the slices' followers until process
        0's fleet shuts down (its :meth:`shutdown` waits for that).
        Remaining ``engine_kwargs`` pass through to every engine."""
        import torch

        from .mesh_exec import SlicePlan
        from .scheduler import PrefixCache

        device = engine_kwargs.get("device")
        if devices is None and device is not None and torch.device(device).type == "cpu":
            devices = [torch.device("cpu")] * (int(tp) * int(num_slices or 1))
        plan = SlicePlan.plan(tp, num_slices=num_slices, devices=devices)
        meshes = [plan.build_mesh(i) for i in range(len(plan))]
        leader = meshes[0].coords["tp"] == 0
        cache_mb = engine_kwargs.pop("prefix_cache_mb", 64.0)
        # Followers build the same kind of cache (their steps must match
        # the leader's), and never look anything up in it.
        shared_cache = None
        if (share_prefix_cache and cache_mb > 0
                and engine_kwargs.get("prefill_chunk", 256) is not None):
            shared_cache = PrefixCache(int(cache_mb * 2 ** 20))

        def _build_slice(i: int, rebuild: bool = False) -> ServingEngine:
            kw = dict(engine_kwargs)
            if make_adapters is not None:
                kw["adapters"] = make_adapters()
            if shared_cache is not None:
                kw["prefix_cache"] = shared_cache
            else:
                kw["prefix_cache_mb"] = cache_mb
            channel = meshes[i].channel
            if rebuild and leader and channel is not None:
                channel.send(BUILD)
            if rebuild:  # every process of the slice: fresh groups on the same devices
                meshes[i].renew_device_group()
            return ServingEngine(model, mesh=meshes[i], **kw)

        engines = [_build_slice(i) for i in range(len(plan))]
        fleet = cls(engines, failover_block_s=failover_block_s, max_failovers=max_failovers,
                    factories=[(lambda i=i: _build_slice(i, rebuild=True))
                               for i in range(len(plan))])
        fleet.slice_plan = plan
        fleet._slice_meshes = meshes
        fleet.leader = leader
        if not leader:
            fleet._follower_threads = [
                threading.Thread(target=fleet._follow_slice, args=(i, _build_slice),
                                 name=f"serving-slice-{i}", daemon=True)
                for i in range(len(plan))]
            for t in fleet._follower_threads:
                t.start()
        return fleet

    def _follow_slice(self, index: int, build: Callable):
        """A follower process's thread for slice ``index``: wait for its
        engine to stop, then rebuild it when the leader rebuilds the slice,
        until the leader's fleet closes."""
        channel = self._slice_meshes[index].channel
        while True:
            engine = self._replicas[index].engine
            thread = engine._thread
            if thread is not None:
                thread.join()
            kind = channel.receive()[0]
            if kind == CLOSE:
                return
            if kind != BUILD:
                raise RuntimeError(f"unexpected message kind {kind} between engines of "
                                   f"slice {index}")
            self._replicas[index].engine = build(index, rebuild=True)

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._replicas)

    @property
    def replicas(self) -> list[_Replica]:
        return list(self._replicas)

    def replica_states(self) -> list[ReplicaState]:
        self.refresh_health()
        return [r.state for r in self._replicas]

    @property
    def ready(self) -> bool:
        """At least one replica is healthy and accepting — the gateway's
        ``/readyz`` condition."""
        return bool(self._candidates())

    def engine(self, index: int) -> ServingEngine:
        return self._replicas[index].engine

    # -- health ----------------------------------------------------------
    #: states a fence/kill must leave alone: FAILED is already fenced
    #: (double-fencing would double-count and, via kill, re-inject a fault
    #: into a replacement engine), RESTARTING is mid-rebuild, CRASH_LOOP
    #: is deliberately parked by the breaker, and PARKED holds no engine
    #: at all — only restart_replica, unpark_replica, or reset_circuit
    #: move a replica out of these.
    _FENCED_STATES = (ReplicaState.FAILED, ReplicaState.RESTARTING,
                      ReplicaState.CRASH_LOOP, ReplicaState.PARKED)

    def refresh_health(self):
        """Demote any replica whose engine died since the last look. Lazy —
        called on every routing decision and metrics read, so there is no
        monitor thread to keep alive (or to crash); a
        :class:`~.supervisor.FleetSupervisor` adds the ACTIVE checks
        (heartbeat watchdog, auto-restart) on top."""
        for r in self._replicas:
            if (r.state not in self._FENCED_STATES
                    and r.engine.error is not None):
                self._fence(r)

    def _fence(self, replica: _Replica):
        with self._lock:
            if replica.state in self._FENCED_STATES:
                return
            replica.state = ReplicaState.FAILED
            self._fences += 1

    def drain_replica(self, index: int):
        """Take one replica out of rotation (e.g. before maintenance): no
        new requests route to it, in-flight streams finish normally. Shut
        the engine down once ``engine(i).free_slots == max_slots``."""
        r = self._replicas[index]
        if r.state is ReplicaState.HEALTHY:
            r.state = ReplicaState.DRAINING

    def kill_replica(self, index: int,
                     error: Optional[BaseException] = None):
        """Fault injection / hard fencing: make replica ``index``'s run
        loop raise at its next iteration (see ``ServingEngine.kill``). Its
        in-flight requests fail over to the surviving replicas.
        Idempotent: a replica already fenced (FAILED / RESTARTING /
        CRASH_LOOP) is left alone — its requests were already resubmitted
        once, and a second kill must not re-inject a fault into the
        replacement engine a restart may have installed meanwhile."""
        r = self._replicas[index]
        with self._lock:
            if r.state in self._FENCED_STATES:
                return
        r.engine.kill(error)

    # -- self-healing (used by FleetSupervisor; callable manually) --------
    def restart_replica(self, index: int, *,
                        join_timeout: float = 5.0) -> ServingEngine:
        """Rebuild a FAILED replica from its retained factory and return
        it to HEALTHY rotation: wait for the dead engine's thread (a
        truly wedged one is abandoned — it is a daemon thread whose
        requests were already failed over, and it keeps the engine and
        its device memory alive while it lives), build + warm a
        replacement (the factory's warmup captures its graphs), replay
        every fleet adapter registration onto its bank, fold the dead
        engine's counters and captures into the retired ledgers (fleet
        totals stay monotone), and only THEN swap it in. Until the swap
        the card holds both engines' pools and graph pools; after it the
        dead engine is unreferenced and its memory returns to the
        allocator. Raises ``RuntimeError`` when the replica has no
        factory or is not FAILED, and propagates factory/warmup errors —
        the caller (supervisor) counts those as failed attempts toward
        the circuit breaker."""
        r = self._replicas[index]
        factory = self._factories[index]
        if factory is None:
            raise RuntimeError(
                f"replica {index} has no factory (build the fleet with "
                "from_factory, or pass factories= to ReplicaSet)")
        with self._lock:
            if r.state is not ReplicaState.FAILED:
                raise RuntimeError(
                    f"replica {index} is {r.state.value}, not failed — "
                    "only a fenced replica can be restarted")
            r.state = ReplicaState.RESTARTING
        old = r.engine
        try:
            # The old engine's thread must be DONE retiring its requests
            # before the swap: _on_inner_finish closures read
            # ``replica.engine.error`` to classify a failure as
            # engine-death, and swapping early would make a late retire
            # read the replacement's None error and skip failover.
            thread = old._thread
            if thread is not None and thread.is_alive():
                old._stop = True
                thread.join(join_timeout)
            try:
                old.shutdown(drain=False, timeout=1.0)
            except Exception:
                pass  # a dead engine re-raises its own fatal error here
            new_engine = factory()
            new_engine.start()  # no-op unless the factory used autostart=False
            if not new_engine.healthy:
                raise RuntimeError(
                    "replacement engine came up unhealthy"
                ) from new_engine.error
            if (new_engine.eos_token_id != self.eos_token_id
                    or new_engine._sampling != old._sampling):
                raise ValueError(
                    "factory built an engine whose eos/sampling config "
                    "disagrees with the fleet — failover would change the "
                    "stream's distribution")
            with self._lock:
                registry = list(self._adapter_registry.items())
            for name, (adapter, kwargs) in registry:
                new_engine.register_adapter(name, adapter, **kwargs)
        except BaseException:
            with self._lock:
                r.state = ReplicaState.FAILED
            raise
        with self._lock:
            self._retire_engine_locked(old)
            r.engine = new_engine
            r.state = ReplicaState.HEALTHY
            r.restarts += 1
            self._restarts += 1
        return new_engine

    def _retire_engine_locked(self, engine: ServingEngine):
        """Fold a replaced or parked engine's counters and graph captures
        into the retired ledgers."""
        self._retired_stats.merge(engine.stats)
        events, secs = engine.compile_watcher.lifetime()
        self._retired_captures = (self._retired_captures[0] + events,
                                  self._retired_captures[1] + secs)

    def trip_breaker(self, index: int):
        """Park a FAILED replica in CRASH_LOOP: it leaves the restart
        rotation entirely (no further rebuild attempts, excluded from
        routing, kill_replica no-ops) until :meth:`reset_circuit`. The
        supervisor calls this when restarts exceed its window budget."""
        r = self._replicas[index]
        with self._lock:
            if r.state is ReplicaState.CRASH_LOOP:
                return
            r.state = ReplicaState.CRASH_LOOP
            self._crash_loops += 1

    def reset_circuit(self, index: int):
        """Operator override: move a CRASH_LOOP replica back to FAILED so
        the supervisor may try restarting it again (e.g. after the
        poisoned host was actually fixed)."""
        r = self._replicas[index]
        with self._lock:
            if r.state is ReplicaState.CRASH_LOOP:
                r.state = ReplicaState.FAILED

    def _note_hang_fence(self):
        with self._lock:
            self._hang_fences += 1

    # -- autoscaling (used by control.FleetAutoscaler; callable manually) --
    def park_replica(self, index: int):
        """Scale-down terminal step: release an IDLE replica's engine
        entirely (decode state, KV pool, captured graphs all freed)
        while keeping its slot and factory, so :meth:`unpark_replica` can
        bring it back later. Only an idle HEALTHY or DRAINING replica may
        be parked — parking live streams would drop tokens, so the
        autoscaler drains first and parks once ``free_slots == max_slots``
        and the queue is empty. The engine's counters fold into the
        retired-stats ledger (fleet totals stay monotone). Raises
        ``RuntimeError`` when the replica has no factory, is not
        HEALTHY/DRAINING, or still holds work."""
        r = self._replicas[index]
        if self._factories[index] is None:
            raise RuntimeError(
                f"replica {index} has no factory — a parked replica could "
                "never be rebuilt (build the fleet with from_factory, "
                "or pass factories= to ReplicaSet)")
        with self._lock:
            if r.state not in (ReplicaState.HEALTHY, ReplicaState.DRAINING):
                raise RuntimeError(
                    f"replica {index} is {r.state.value} — only a healthy "
                    "or draining replica can be parked")
            engine = r.engine
            if (engine.free_slots != engine.max_slots
                    or engine.queue_depth > 0):
                raise RuntimeError(
                    f"replica {index} still holds work "
                    f"({engine.max_slots - engine.free_slots} active, "
                    f"{engine.queue_depth} queued) — drain it first")
            r.state = ReplicaState.PARKED
        try:
            engine.shutdown(drain=False, timeout=1.0)
        except Exception:
            pass  # an already-dead engine re-raises its own error here
        with self._lock:
            self._retire_engine_locked(engine)
            r.engine = None
            self._scale_downs += 1

    def unpark_replica(self, index: int) -> ServingEngine:
        """Scale-up: rebuild a PARKED replica from its retained factory
        and return it to HEALTHY rotation — :meth:`restart_replica`'s
        twin minus the dead-engine teardown (there is no engine to tear
        down). The rebuild is validated against the CAPTURED fleet
        eos/sampling config and replays every fleet adapter registration,
        so scale-up is tenant-preserving. Propagates factory/warmup
        errors with the replica returned to PARKED — the autoscaler
        counts those and backs off."""
        r = self._replicas[index]
        factory = self._factories[index]
        if factory is None:
            raise RuntimeError(f"replica {index} has no factory")
        with self._lock:
            if r.state is not ReplicaState.PARKED:
                raise RuntimeError(
                    f"replica {index} is {r.state.value}, not parked — "
                    "only a parked replica can be unparked")
            r.state = ReplicaState.RESTARTING
        try:
            new_engine = factory()
            new_engine.start()
            if not new_engine.healthy:
                raise RuntimeError(
                    "replacement engine came up unhealthy"
                ) from new_engine.error
            if (new_engine.eos_token_id != self._eos
                    or new_engine._sampling != self._sampling):
                raise ValueError(
                    "factory built an engine whose eos/sampling config "
                    "disagrees with the fleet — failover would change the "
                    "stream's distribution")
            with self._lock:
                registry = list(self._adapter_registry.items())
            for name, (adapter, kwargs) in registry:
                new_engine.register_adapter(name, adapter, **kwargs)
        except BaseException:
            with self._lock:
                r.state = ReplicaState.PARKED
            raise
        with self._lock:
            r.engine = new_engine
            r.state = ReplicaState.HEALTHY
            r.restarts += 1
            self._scale_ups += 1
        return new_engine

    def add_parked(self, factory: Callable[[], ServingEngine]) -> int:
        """Append a PARKED engine-less replica slot holding only
        ``factory`` — headroom the autoscaler can later spawn into
        without the fleet ever paying for an engine it hasn't needed yet.
        Returns the new replica's index."""
        with self._lock:
            index = len(self._replicas)
            r = _Replica(index, None)
            r.state = ReplicaState.PARKED
            self._replicas.append(r)
            self._factories.append(factory)
        return index

    # -- projected pressure (gateway shed inputs) -------------------------
    def projected_page_deficit(self, total_tokens: int) -> int:
        """Fleet-level projected page shortfall for a ``total_tokens``
        request: the MINIMUM over healthy replicas of
        :meth:`~.engine.ServingEngine.projected_page_deficit` — one
        replica with headroom means the request has a home, so only when
        EVERY healthy replica is short does the gateway shed. 0 when any
        replica is dense or has room (and when none is healthy — the
        no-replica path 503s instead)."""
        deficits = [r.engine.projected_page_deficit(total_tokens)
                    for r in self._replicas
                    if r.state is ReplicaState.HEALTHY and r.engine.healthy]
        return min(deficits) if deficits else 0

    def page_drain_rate(self) -> float:
        """Observed pages/s freed across the healthy fleet (sum over
        replicas) — the denominator of the shed path's Retry-After."""
        return sum(r.engine.page_drain_rate() for r in self._replicas
                   if r.state is ReplicaState.HEALTHY and r.engine.healthy)

    def admission_capacity(self) -> int:
        """Total streams the healthy fleet can hold at once — decode
        slots plus admission-queue depth, summed over healthy replicas.
        The denominator of the gateway's fair-share occupancy check."""
        return sum(r.engine.max_slots + r.engine._queue.max_queued
                   for r in self._replicas
                   if r.state is ReplicaState.HEALTHY and r.engine.healthy)

    @property
    def eos_token_id(self):
        """The fleet-shared eos id (validated identical across replicas;
        captured at construction so it survives replica 0 being parked)."""
        return self._eos

    # -- routing ---------------------------------------------------------
    def _candidates(self, adapter: Optional[str] = None,
                    total_tokens: int = 0,
                    prompt_ids=None) -> list[_Replica]:
        """Healthy replicas, best-first: replicas with a free slot before
        saturated ones, then longest cached prefix for THIS prompt, then
        most free decode slots, then lowest total occupancy, then KV-page
        headroom, then index (stable). ``total_tokens`` (prompt + max_new)
        folds the paged pool into the score: a replica whose pool is
        short pages for THIS request (``engine.page_deficit``) loses the
        tie-break to one with room, and among un-starved replicas more
        ``free_pages`` wins — so long prompts route to replicas with free
        pages instead of forcing preemption (``fleet_free_pages`` is the
        same signal summed fleet-wide in :meth:`fleet_metrics`).
        ``prompt_ids`` enables prefix-cache-aware placement: each
        replica's :meth:`~.engine.ServingEngine.cached_prefix_tokens`
        probe (pure host hashing, no LRU promotion) scores how much
        prefill the replica can skip, so shared-system-prompt traffic
        lands where its KV already lives — but never at the cost of
        queueing behind a saturated replica while another has a free slot
        (the leading ``no-free-slot`` term). When the request names a
        LoRA adapter, replicas with that adapter already RESIDENT in
        their device bank rank first (routing affinity saves a host→
        device row upload), engines built without a bank drop out
        entirely, and the same order breaks ties."""
        self.refresh_health()
        cands = [r for r in self._replicas
                 if r.state is ReplicaState.HEALTHY and r.engine.healthy
                 and (adapter is None or r.engine.adapters is not None)]

        def _cached(r):
            if prompt_ids is None:
                return 0
            return r.engine.cached_prefix_tokens(prompt_ids, adapter)

        def _pages_key(r):
            return (r.engine.page_deficit(total_tokens), -r.engine.free_pages)

        if adapter is None:
            cands.sort(key=lambda r: (r.engine.free_slots == 0, -_cached(r),
                                      -r.engine.free_slots, r.engine.load,
                                      *_pages_key(r), r.index))
        else:
            cands.sort(key=lambda r: (not r.engine.adapter_resident(adapter),
                                      r.engine.free_slots == 0, -_cached(r),
                                      -r.engine.free_slots, r.engine.load,
                                      *_pages_key(r), r.index))
        return cands

    def submit(self, prompt_ids=None, *, max_new_tokens: int = 20,
               seed: Optional[int] = None, rng=None,
               timeout: Optional[float] = None, on_token=None,
               ignore_eos: bool = False, adapter: Optional[str] = None,
               trace_id: Optional[str] = None,
               priority: Optional[str] = None,
               block: bool = False,
               block_timeout: Optional[float] = None) -> FleetRequest:
        """Route one request to the least-loaded healthy replica; returns
        a :class:`FleetRequest` immediately. Raises
        :class:`~.scheduler.QueueFull` when every healthy replica's
        admission queue is full (``block=True`` waits for space on the
        best one first, up to ``block_timeout``), ``RuntimeError`` when no
        replica is healthy at all, and ``LookupError``
        (:class:`~..adapters.registry.UnknownAdapterError`) when
        ``adapter`` names an adapter no healthy replica has registered —
        the signal the gateway maps to HTTP 404."""
        fleet = FleetRequest(prompt_ids, max_new_tokens=max_new_tokens,
                             rng=rng, seed=seed, timeout=timeout,
                             on_token=on_token, ignore_eos=ignore_eos,
                             adapter=adapter, trace_id=trace_id,
                             priority=priority)
        fleet.submitted_at = time.monotonic()
        with self._lock:
            self._submitted += 1
        self._dispatch(fleet, block=block, block_timeout=block_timeout)
        return fleet

    def _dispatch(self, fleet: FleetRequest, *, block: bool,
                  block_timeout: Optional[float], _raise: bool = True):
        """Try candidates best-first with non-blocking submits; only after
        ALL are queue-full does ``block=True`` wait on the current best.
        With ``_raise=False`` (failover path, running on a dead engine's
        thread) failures finish the fleet request instead of raising."""
        last_exc: Optional[BaseException] = None
        saturated = False
        # Page-aware score input: tokens this request will occupy (prompt +
        # already-generated on failover resume + remaining decode budget).
        total_tokens = (int(fleet.prompt_ids.shape[1]) + len(fleet.tokens)
                        + int(fleet.max_new_tokens))
        # Cache-aware score input: the prompt that will actually prefill
        # (the RESUME prompt on failover — its longer prefix is exactly
        # what the dead replica's shared-cache inserts make warm).
        probe_ids = fleet._resume_prompt()
        for attempt in range(2):
            for r in self._candidates(fleet.adapter, total_tokens=total_tokens,
                                      prompt_ids=probe_ids):
                inner = self._make_inner(fleet, r)
                if inner is None:  # cancelled or deadline passed meanwhile
                    return
                try:
                    r.engine.submit(
                        request=inner,
                        block=block and attempt > 0,
                        block_timeout=block_timeout)
                except QueueFull as e:
                    last_exc, saturated = e, True
                    continue
                except LookupError as e:
                    # THIS replica's registry doesn't know the adapter
                    # (registries may trail during a rollout) — try the
                    # next one; when nobody knows, the LookupError
                    # surfaces to the caller as-is (gateway → 404).
                    last_exc = e
                    continue
                except RuntimeError as e:
                    # Died between the health check and the enqueue.
                    last_exc = e
                    self._fence(r)
                    continue
                with fleet._lock:
                    fleet._inner = inner
                fleet.replica_trail.append(r.index)
                if fleet.cancel_requested:
                    inner.cancel()  # cancel raced the dispatch
                return
            if not (block and saturated):
                break
        if _raise:
            if saturated:
                raise QueueFull(
                    "every healthy replica's admission queue is full; "
                    "retry later") from last_exc
            if isinstance(last_exc, LookupError):
                raise last_exc
            raise RuntimeError(
                "no healthy replica available") from last_exc
        with self._lock:
            self._failover_failed += 1
        fleet._finish(RequestStatus.FAILED, RuntimeError(
            "failover found no healthy replica with queue space")
            if last_exc is None else last_exc)

    def _make_inner(self, fleet: FleetRequest,
                    replica: _Replica) -> Optional[Request]:
        """Build the next flight: the remaining-budget request whose prompt
        is ``original + emitted`` (so token budgets, deadline, and KV
        occupancy all add up to exactly the uninterrupted request's)."""
        if fleet.cancel_requested:
            fleet._finish(RequestStatus.CANCELLED)
            return None
        remaining_t = fleet._remaining_timeout()
        if remaining_t is not None and remaining_t <= 0:
            fleet._finish(RequestStatus.TIMED_OUT)
            return None
        inner = Request(fleet._resume_prompt(),
                        max_new_tokens=fleet._remaining_new_tokens(),
                        rng=fleet.rng, seed=fleet.seed,
                        timeout=remaining_t, on_token=None,
                        ignore_eos=fleet.ignore_eos,
                        adapter=fleet.adapter,
                        trace_id=fleet.trace_id,
                        priority=fleet.priority)
        inner.on_token = lambda tok, _inner=inner: fleet._emit_from(
            _inner, tok)
        inner._on_finish = lambda req: self._on_inner_finish(
            fleet, replica, req)
        # Mark this as the live flight BEFORE submission: the engine may
        # emit tokens before _dispatch gets around to recording _inner.
        # Dispatch builds inners strictly one at a time (a candidate that
        # rejected the submit never emitted), so latest-built == live.
        with fleet._lock:
            fleet._flight = inner
        return inner

    # -- adapters ---------------------------------------------------------
    def register_adapter(self, name: str, adapter, **kwargs):
        """Register a LoRA adapter on EVERY replica's bank. Fleet-wide
        registration is what makes failover tenant-preserving: a stream
        decoding under adapter X can resume on any survivor, which loads
        X into its own bank at admission if it isn't already resident.
        Raises ``RuntimeError`` if any replica was built without an
        :class:`~..adapters.registry.AdapterBank`. Registrations are
        RECORDED: a replica rebuilt by :meth:`restart_replica` replays
        them onto its fresh bank, so restarts are tenant-preserving —
        and a PARKED replica (no engine) picks them up at unpark."""
        for r in self._replicas:
            if r.engine is not None:
                r.engine.register_adapter(name, adapter, **kwargs)
        with self._lock:
            self._adapter_registry[name] = (adapter, dict(kwargs))

    def unregister_adapter(self, name: str):
        """Drop a named adapter from every replica that knows it (idle
        banks only free the device row lazily on the next eviction)."""
        with self._lock:
            self._adapter_registry.pop(name, None)
        for r in self._replicas:
            bank = r.engine.adapters if r.engine is not None else None
            if bank is not None and name in bank.names():
                bank.unregister(name)

    # -- failover ---------------------------------------------------------
    def _on_inner_finish(self, fleet: FleetRequest, replica: _Replica,
                         inner: Request):
        """Runs ON THE ENGINE THREAD at the inner request's terminal
        transition. Engine-death failures fence the replica and resubmit;
        everything else (completion, cancellation, deadline, a raising
        user callback) passes through to the fleet handle."""
        if inner.status is RequestStatus.FAILED \
                and replica.engine.error is not None \
                and not fleet.cancel_requested:
            self._fence(replica)
            # Attach the dead replica's postmortem (its engine froze the
            # flight-recorder dump — fatal event included — before this
            # retire sweep started) so the hop is debuggable after the
            # fact without the replica.
            report = {
                "trace_id": fleet.trace_id,
                "replica": replica.index,
                "error": repr(replica.engine.error),
                "tokens_at_failover": len(fleet.tokens),
                "flight_recorder": replica.engine.postmortem(),
            }
            with self._lock:
                self._failover_reports.append(report)
                del self._failover_reports[:-32]  # keep the last 32 hops
            if fleet.failovers >= self._max_failovers:
                fleet._finish(RequestStatus.FAILED, RuntimeError(
                    f"request failed over {fleet.failovers} times "
                    "(max_failovers reached)"))
                return
            with self._lock:
                self._failovers += 1
                replica.failures += 1
            self._dispatch(fleet, block=True,
                           block_timeout=self._failover_block_s,
                           _raise=False)
            return
        fleet._finish(inner.status, inner.error)

    @property
    def failover_reports(self) -> list[dict]:
        """Postmortems for the most recent failover hops (newest last):
        ``{trace_id, replica, error, tokens_at_failover, flight_recorder}``
        where ``flight_recorder`` is the dead engine's frozen event dump
        (fatal event included). Bounded to the last 32 hops."""
        with self._lock:
            return list(self._failover_reports)

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        """One fleet-wide Chrome-trace dict: every replica's buffered
        spans (optionally filtered to one ``trace_id``) merged onto the
        shared monotonic timeline — a failed-over request shows its
        replica-A spans next to its replica-B continuation. Backs the
        gateway's ``GET /debug/trace``."""
        from ..observability import merge_chrome_traces

        return merge_chrome_traces(
            r.engine.chrome_trace(trace_id) for r in self._replicas
            if r.engine is not None)

    # -- metrics ----------------------------------------------------------
    def merged_stats(self) -> ServingStats:
        """A fresh :class:`ServingStats` holding the fleet-wide fold of
        every replica's counters (see ``ServingStats.merge``), INCLUDING
        the retired-stats ledger of engines replaced by
        :meth:`restart_replica` — fleet totals are monotone across
        restarts, not reset by them."""
        merged = ServingStats()
        with self._lock:
            merged.merge(self._retired_stats)
        for r in self._replicas:
            if r.engine is not None:
                merged.merge(r.engine.stats)
        return merged

    def capture_totals(self) -> tuple:
        """``(graph capture events, capture seconds)`` of every engine the
        fleet ever held, retired ones included (monotone across restarts;
        warmup captures counted): the gateway's capture counters."""
        with self._lock:
            events, secs = self._retired_captures
            engines = [r.engine for r in self._replicas if r.engine is not None]
        for e in engines:
            ev, sc = e.compile_watcher.lifetime()
            events, secs = events + ev, secs + sc
        return events, secs

    def fleet_metrics(self) -> dict:
        """Merged engine summary plus router-level counters (replica
        states, failover/fence counts) — the dict behind ``/metrics``."""
        self.refresh_health()
        out = self.merged_stats().summary()
        states = [r.state for r in self._replicas]
        with self._lock:
            out.update({
                "replicas": len(self._replicas),
                "replicas_healthy": sum(
                    s is ReplicaState.HEALTHY for s in states),
                "replicas_draining": sum(
                    s is ReplicaState.DRAINING for s in states),
                "replicas_failed": sum(
                    s is ReplicaState.FAILED for s in states),
                "replicas_restarting": sum(
                    s is ReplicaState.RESTARTING for s in states),
                "replicas_crash_loop": sum(
                    s is ReplicaState.CRASH_LOOP for s in states),
                "replicas_parked": sum(
                    s is ReplicaState.PARKED for s in states),
                "fleet_submitted": self._submitted,
                "fleet_failovers": self._failovers,
                "fleet_fences": self._fences,
                "fleet_failover_failed": self._failover_failed,
                "fleet_restarts": self._restarts,
                "fleet_hang_fences": self._hang_fences,
                "fleet_crash_loops": self._crash_loops,
                "fleet_scale_ups": self._scale_ups,
                "fleet_scale_downs": self._scale_downs,
                # One autoscale actuation = one unpark or one park; the
                # loop-closure gauge the SLO acceptance reads.
                "fleet_autoscale_events": self._scale_ups + self._scale_downs,
                "fleet_free_slots": sum(
                    r.engine.free_slots for r in self._replicas
                    if r.state is ReplicaState.HEALTHY and r.engine.healthy),
                # Paged-KV headroom across the healthy fleet (0 when every
                # replica is dense). Page pressure already steers routing
                # through ``engine.load``; this is the operator's view.
                "fleet_free_pages": sum(
                    r.engine.free_pages for r in self._replicas
                    if r.state is ReplicaState.HEALTHY and r.engine.healthy),
                # Observed pages/s returning to the healthy fleet's pools
                # — the drain rate behind shed Retry-After values.
                "fleet_page_drain_rate": round(sum(
                    r.engine.page_drain_rate() for r in self._replicas
                    if r.state is ReplicaState.HEALTHY
                    and r.engine.healthy), 4),
            })
        return out

    # -- lifecycle --------------------------------------------------------
    def drain(self):
        """Stop routing new work everywhere (all HEALTHY → DRAINING);
        in-flight streams keep running. The gateway's SIGTERM path."""
        for r in self._replicas:
            if r.state is ReplicaState.HEALTHY:
                r.state = ReplicaState.DRAINING

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Shut every replica down (``drain=True`` finishes accepted work
        first). Replicas that already died are fenced, not re-raised —
        their error was already delivered to their requests. A fleet of
        slices then closes each slice's channel (its followers' processes
        stop following); a follower process's fleet waits for that."""
        if not self.leader:
            for t in self._follower_threads:
                t.join(timeout)
            return
        first_exc: Optional[BaseException] = None
        for r in self._replicas:
            if r.engine is None:  # parked: nothing to shut down
                continue
            try:
                r.engine.shutdown(drain=drain, timeout=timeout)
            except RuntimeError as e:
                self._fence(r)
                if r.engine.error is None and first_exc is None:
                    first_exc = e
        if not self._closed_slices:
            self._closed_slices = True
            for mesh in self._slice_meshes:
                if mesh.channel is not None:
                    mesh.channel.send(CLOSE)
        if first_exc is not None:
            raise first_exc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)
