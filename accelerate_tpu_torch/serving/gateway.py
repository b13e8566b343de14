"""Stdlib-only HTTP gateway over a :class:`~.router.ReplicaSet`.

Counterpart of ``accelerate_tpu/serving/gateway.py``: the same routes,
status codes, JSON and SSE shapes, and ``/metrics`` families, but one.
The JAX gateway counts the process's XLA compiles
(``accelerate_tpu_xla_compile_events_total`` and ``_seconds_total``);
here the replicas' steps are CUDA graphs, so the gateway counts their
captures (``accelerate_tpu_graph_capture_events_total`` and
``_seconds_total``): every engine the fleet held since the gateway
started, retired ones included, so the counters stay monotone across
restarts. ``accelerate_tpu_xla_compilation_cache_hits_total`` keeps its
name for scrape compatibility and stays 0 (no compilation cache here).

The network front door of the serving stack, with TWO interchangeable
front ends behind one :class:`ServingGateway` API
(``GatewayConfig(server=...)``):

* ``server="asyncio"`` (default) — a single-threaded :mod:`asyncio`
  event loop (``gateway_aio``) multiplexing thousands of concurrent SSE
  streams per process. The engine-facing side stays thread-based;
  tokens cross from the engines' emitter threads onto the loop via
  ``loop.call_soon_threadsafe`` into bounded per-stream queues, and
  request completion rides :meth:`~.router.FleetRequest
  .add_done_callback` — no handler thread ever parks in ``wait()``.
* ``server="threading"`` — the original ``ThreadingHTTPServer`` (one
  handler thread per connection; the handlers only wait on queues and
  sockets, all model work stays on the engine threads). One OS thread
  per open stream caps it at hundreds of connections — kept for A/B
  comparison and for deployments where a proxy bounds concurrency.

Both front ends expose the same routes and speak the same HTTP:

* ``POST /v1/completions`` — JSON in, JSON out, or Server-Sent Events
  when ``"stream": true`` (one ``data:`` event per token as the engine
  commits it, then a final summary event). Prompts are token-id lists —
  the repo has no tokenizer dependency, and the serving tests need
  bit-exact comparison against offline ``generate`` anyway.
* ``GET /healthz`` — liveness: 200 while the process serves HTTP at all.
* ``GET /readyz`` — readiness: 200 only when the gateway is not draining
  AND at least one replica is healthy and warm; 503 otherwise. Wire this
  one into the load balancer.
* ``GET /metrics`` — Prometheus text exposition: the fleet-merged engine
  counters (``ServingStats.merge`` across replicas) plus real
  cumulative-bucket latency histograms, router health/failover counters,
  the fleet's graph-capture counters, and the gateway's own HTTP counters.
* ``GET /debug/trace?id=<trace_id>`` — the fleet's buffered spans as
  Chrome-trace/Perfetto JSON (``id`` narrows to one request; the id is
  minted per request — or taken from the client's ``X-Request-Id``
  header — and echoed in every response body and header).

Backpressure and failure map onto HTTP status codes instead of queues
growing without bound: every healthy replica's admission queue full →
**429** with ``Retry-After``; projected KV-page demand of admitted +
queued work past the paged pools' headroom (and not clearing within
``shed_wait_s`` at the observed page-drain rate) → **429** whose
``Retry-After`` is *derived from that drain rate*, shedding work the
queues would accept and then time out on; a tenant over its token-bucket
rate limit (``rate_limits``) → **429** whose ``Retry-After`` is the
bucket's refill time; a tenant over its weighted fair share of in-flight
streams while the fleet is under pressure (``fair_share_weights``) →
**429**; all derived Retry-After values clamp into the shared
``[retry_after_s, retry_after_max_s]`` window; per-request deadline
expired → **408**;
request body over the cap → **413**; connection cap hit, gateway
draining, or no healthy replica → **503**; malformed request → **400**.
Multi-tenant LoRA maps the same way: ``"adapter"`` naming an adapter no
replica has registered → **404** ``unknown_adapter``; every bank row
pinned by an in-flight stream (momentary residency pressure) → **503**
``adapter_bank_full`` with ``Retry-After``.

Graceful drain: ``shutdown(drain=True)`` (also wired to SIGTERM/SIGINT
by :meth:`ServingGateway.install_signal_handlers`) flips the gateway to
draining — ``/readyz`` goes 503 so balancers stop sending, new
completions are refused with 503 — waits for in-flight HTTP exchanges
to finish, then drains the replicas themselves (see
``ServingEngine.shutdown``).
"""

from __future__ import annotations

import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..adapters.registry import AdapterBankFull
from ..observability import clean_trace_id, new_trace_id
from .engine import ServingEngine
from .metrics import GatewayStats
from .request import RequestStatus
from .router import ReplicaSet
from .scheduler import QueueFull

__all__ = ["ServingGateway", "GatewayConfig"]


class GatewayConfig:
    """Knobs for the HTTP layer (the model/engine knobs live on the
    engines themselves).

    Args:
      server: which front end serves the HTTP: ``"asyncio"`` (default —
        one event loop multiplexing every connection) or ``"threading"``
        (one handler thread per connection). Same routes, same status
        codes, same drain semantics either way.
      host: bind address (default loopback — put a real proxy in front
        before binding wider).
      port: TCP port; **0 asks the OS for an ephemeral port** (read it
        back from ``gateway.port`` — this is what the tests use, so no
        fixed-port flakes).
      max_body_bytes: request bodies over this are refused with 413
        before being read into memory.
      max_connections: concurrent in-flight HTTP exchanges; past it new
        requests get 503 (the admission queues provide the real
        backpressure — this cap only bounds front-end state). ``None``
        picks a per-front-end default: 64 for threading (it is a THREAD
        cap there) vs 8192 for asyncio (an open socket costs a few KB,
        not a stack).
      sse_heartbeat_s: emit an SSE comment frame (``: ping``) on any
        stream that has written nothing for this many seconds (e.g.
        sitting deep in a PREFILLING backlog) so proxies and LBs don't
        sever long-queued streams as idle. ``None`` (default) disables
        — tests compare byte-exact SSE bodies.
      stream_queue_tokens: bound of the per-stream token queue between
        the engine's emitter thread and the front end (tokens buffered
        ahead of a slow client; overflow spills to an ordered side list
        so no token is ever dropped — the engine's own bounded
        ``emission_queue`` is the upstream flow control).
      default_max_new_tokens: used when a completion request omits
        ``max_new_tokens``.
      max_new_tokens_cap: hard per-request ceiling (400 past it);
        ``None`` defers entirely to the engines' ``max_len`` check.
      default_timeout_s: per-request deadline applied when the body
        omits ``timeout``; ``None`` means no deadline.
      retry_after_s: floor for the ``Retry-After`` header on 429/503
        (queue-full and drain refusals use it as-is).
      drain_grace_s: how long ``shutdown(drain=True)`` waits for
        in-flight HTTP exchanges before proceeding anyway.
      shed_projected_pressure: refuse (429) a completion whose projected
        KV-page demand — together with everything already admitted and
        queued — cannot be covered by the paged pools within
        ``shed_wait_s`` at the fleet's *observed* page-drain rate.
        This sheds load the queues would otherwise accept and then time
        out on. With no observed drain yet (cold start) or on dense
        engines nothing is shed.
      shed_wait_s: the pressure-shed horizon: admit as long as the
        projected page deficit clears within this many seconds of
        observed drain.
      retry_after_max_s: cap on the drain-rate-derived ``Retry-After``
        of a pressure shed (the floor is ``retry_after_s``); the same
        clamp bounds rate-limit Retry-After values.
      rate_limits: per-tenant token-bucket request rates — a dict
        ``{tenant: requests_per_s}`` keyed on adapter name (base-model
        traffic is tenant ``"_base"``; the ``"*"`` key sets a default
        for unlisted tenants). ``None`` (default) disables rate
        limiting. Refusals are structured 429s whose ``Retry-After``
        derives from the tenant bucket's refill time.
      rate_limit_burst_s: bucket capacity in seconds of budget — a
        tenant may burst ``rate * burst_s`` requests after idling.
      fair_share_weights: weighted fair-share admission over in-flight
        streams — ``{tenant: weight}`` (``"*"`` = default weight).
        ``None`` disables fair share. Work-conserving: tenants borrow
        idle capacity freely until fleet admission occupancy crosses
        ``fair_share_pressure``, past which a tenant over its weighted
        share is shed (429) so under-share tenants keep finding room.
      fair_share_pressure: occupancy fraction of fleet admission
        capacity (slots + queue depth) past which fair share enforces.
    """

    #: per-front-end ``max_connections=None`` defaults (threads are the
    #: scarce resource one way, sockets the other).
    DEFAULT_MAX_CONNECTIONS = {"threading": 64, "asyncio": 8192}

    def __init__(self, *, server: str = "asyncio",
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: int = 1 << 20,
                 max_connections: Optional[int] = None,
                 default_max_new_tokens: int = 32,
                 max_new_tokens_cap: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 drain_grace_s: float = 30.0,
                 shed_projected_pressure: bool = True,
                 shed_wait_s: float = 5.0,
                 retry_after_max_s: float = 60.0,
                 sse_heartbeat_s: Optional[float] = None,
                 stream_queue_tokens: int = 256,
                 rate_limits: Optional[dict] = None,
                 rate_limit_burst_s: float = 2.0,
                 fair_share_weights: Optional[dict] = None,
                 fair_share_pressure: float = 0.85):
        if server not in self.DEFAULT_MAX_CONNECTIONS:
            raise ValueError(
                f"server must be one of "
                f"{sorted(self.DEFAULT_MAX_CONNECTIONS)} (got {server!r})")
        if max_connections is None:
            max_connections = self.DEFAULT_MAX_CONNECTIONS[server]
        if max_body_bytes < 1 or max_connections < 1:
            raise ValueError("max_body_bytes and max_connections must be >= 1")
        if shed_wait_s <= 0 or retry_after_max_s <= 0:
            raise ValueError("shed_wait_s and retry_after_max_s must be > 0")
        if sse_heartbeat_s is not None and sse_heartbeat_s <= 0:
            raise ValueError("sse_heartbeat_s must be > 0 or None")
        if stream_queue_tokens < 1:
            raise ValueError("stream_queue_tokens must be >= 1")
        self.server = server
        self.host = host
        self.port = int(port)
        self.max_body_bytes = int(max_body_bytes)
        self.max_connections = int(max_connections)
        self.sse_heartbeat_s = (None if sse_heartbeat_s is None
                                else float(sse_heartbeat_s))
        self.stream_queue_tokens = int(stream_queue_tokens)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_new_tokens_cap = max_new_tokens_cap
        self.default_timeout_s = default_timeout_s
        self.retry_after_s = float(retry_after_s)
        self.drain_grace_s = float(drain_grace_s)
        self.shed_projected_pressure = bool(shed_projected_pressure)
        self.shed_wait_s = float(shed_wait_s)
        self.retry_after_max_s = float(retry_after_max_s)
        self.rate_limits = None if rate_limits is None else dict(rate_limits)
        self.rate_limit_burst_s = float(rate_limit_burst_s)
        self.fair_share_weights = (None if fair_share_weights is None
                                   else dict(fair_share_weights))
        self.fair_share_pressure = float(fair_share_pressure)


#: request terminal status -> (HTTP code, wire status string)
_STATUS_HTTP = {
    RequestStatus.COMPLETED: (200, "completed"),
    RequestStatus.TIMED_OUT: (408, "timed_out"),
    RequestStatus.CANCELLED: (500, "cancelled"),
    RequestStatus.FAILED: (500, "failed"),
}


#: Curated ``# HELP`` strings for the best-known /metrics families;
#: anything unlisted gets a generic description (promlint only requires
#: that every family HAS one).
_METRIC_HELP = {
    "accelerate_tpu_serving_ttft_ms":
        "Mean time-to-first-token over retired requests (ms).",
    "accelerate_tpu_serving_itl_ms":
        "Mean inter-token latency over decode ticks, device-complete to "
        "device-complete (ms).",
    "accelerate_tpu_serving_host_us_per_tick":
        "Mean host scheduling+commit wall per decode tick (us) — the "
        "non-device share of ITL the async host runtime overlaps.",
    "accelerate_tpu_serving_host_us_per_tick_max":
        "Worst observed host scheduling+commit wall for one tick (us).",
    "accelerate_tpu_serving_emission_stalls":
        "Decode-tick skips of streams whose bounded emission queue was "
        "full (slow on_token consumer flow-controlled).",
    "accelerate_tpu_serving_queue_wait_ms":
        "Mean admission-queue wait over admitted requests (ms).",
    "accelerate_tpu_serving_decode_tokens_per_sec":
        "Committed decode tokens per second of decode-tick wall time.",
    "accelerate_tpu_serving_fleet_failovers":
        "Requests resubmitted to a survivor after their replica died.",
    "accelerate_tpu_serving_fleet_fences":
        "Replicas demoted to FAILED and taken out of rotation.",
    "accelerate_tpu_serving_fleet_restarts":
        "Fenced replicas rebuilt, re-warmed, and returned to rotation.",
    "accelerate_tpu_serving_fleet_hang_fences":
        "Replicas fenced by the supervisor watchdog on heartbeat stall "
        "(engine alive but silent past hang_timeout).",
    "accelerate_tpu_serving_fleet_crash_loops":
        "Replicas parked in CRASH_LOOP by the restart circuit breaker.",
    "accelerate_tpu_serving_replicas_crash_loop":
        "Replicas currently parked in CRASH_LOOP awaiting operator reset.",
    "accelerate_tpu_serving_fleet_page_drain_rate":
        "Observed KV pages freed per second across healthy replicas.",
    "accelerate_tpu_serving_replicas_parked":
        "Replicas currently scaled down to PARKED (engine released, "
        "factory retained for autoscale spawn).",
    "accelerate_tpu_serving_fleet_scale_ups":
        "PARKED replicas rebuilt into rotation by autoscaling.",
    "accelerate_tpu_serving_fleet_scale_downs":
        "Idle replicas drained and parked by autoscaling.",
    "accelerate_tpu_serving_fleet_autoscale_events":
        "Total autoscale actuations (scale-ups plus scale-downs) — the "
        "loop-closure signal.",
    "accelerate_tpu_gateway_pressure_sheds":
        "Completions refused (429) on projected KV-page pressure rather "
        "than queue depth.",
    "accelerate_tpu_gateway_rate_limit_sheds":
        "Completions refused (429) by the per-tenant token-bucket rate "
        "limit; Retry-After derives from the bucket's refill time.",
    "accelerate_tpu_gateway_fair_share_sheds":
        "Completions refused (429) by weighted fair-share admission — "
        "tenant over its share while the fleet is under pressure.",
    "accelerate_tpu_gateway_http_requests":
        "HTTP requests accepted past the connection cap.",
    "accelerate_tpu_gateway_http_inflight":
        "HTTP exchanges currently in flight.",
    "accelerate_tpu_gateway_open_sse_streams":
        "SSE streams currently open (the front end's live concurrency).",
    "accelerate_tpu_gateway_open_sse_streams_max":
        "High-water mark of concurrently open SSE streams.",
    "accelerate_tpu_gateway_conn_rejections":
        "Requests refused (503) at the connection cap — front-end "
        "saturation, distinct from queue-full 429s.",
}


class _BadRequest(ValueError):
    """Client error carrying the 400 payload message."""


def parse_completion(body: dict, cfg: GatewayConfig) -> dict:
    """Validate a ``POST /v1/completions`` JSON body into a submit spec.

    Transport-independent — both the threading handler and the asyncio
    front end funnel through here, so the 400-vs-413 surface cannot
    drift between them. Raises :class:`_BadRequest` with the client-
    facing message on any malformed field."""
    prompt = body.get("prompt")
    if prompt is None:
        raise _BadRequest('missing "prompt" (a list of token ids — '
                          "this gateway serves token ids, not text)")
    try:
        ids = np.asarray(prompt, np.int32)
    except (ValueError, TypeError):
        raise _BadRequest('"prompt" must be a list of token ids '
                          "(optionally nested [[...]])") from None
    if ids.ndim not in (1, 2) or ids.size < 1:
        raise _BadRequest('"prompt" must be a non-empty [S] or [1, S] '
                          "list of token ids")
    max_new = body.get("max_new_tokens", cfg.default_max_new_tokens)
    if not isinstance(max_new, int) or max_new < 1:
        raise _BadRequest('"max_new_tokens" must be a positive integer')
    if (cfg.max_new_tokens_cap is not None
            and max_new > cfg.max_new_tokens_cap):
        raise _BadRequest(
            f'"max_new_tokens" {max_new} exceeds the gateway cap '
            f"({cfg.max_new_tokens_cap})")
    seed = body.get("seed")
    if seed is not None and not isinstance(seed, int):
        raise _BadRequest('"seed" must be an integer')
    timeout = body.get("timeout", cfg.default_timeout_s)
    if timeout is not None and (not isinstance(timeout, (int, float))
                                or timeout <= 0):
        raise _BadRequest('"timeout" must be a positive number')
    adapter = body.get("adapter")
    if adapter is not None and (not isinstance(adapter, str)
                                or not adapter):
        raise _BadRequest('"adapter" must be a non-empty string '
                          "(a registered LoRA adapter name) or omitted")
    priority = body.get("priority")
    if priority is not None and (not isinstance(priority, str)
                                 or not priority):
        raise _BadRequest('"priority" must be a non-empty string '
                          '(a traffic class like "interactive"/"batch") '
                          "or omitted")
    return {
        "prompt_ids": ids,
        "max_new_tokens": max_new,
        "seed": seed,
        "timeout": None if timeout is None else float(timeout),
        "ignore_eos": bool(body.get("ignore_eos", False)),
        "adapter": adapter,
        "priority": priority,
        "stream": bool(body.get("stream", False)),
    }


def clamp_retry_after(cfg: GatewayConfig, seconds: float) -> float:
    """Bound a derived ``Retry-After`` into the gateway's shared
    ``[retry_after_s, retry_after_max_s]`` window. EVERY shed that
    computes its own backoff (pressure drain-rate, rate-limit bucket
    refill) funnels through here — one clamp, both front ends, so no
    response ever advertises an unbounded or sub-floor retry."""
    return min(max(float(seconds), cfg.retry_after_s), cfg.retry_after_max_s)


def tenant_of(spec: dict) -> str:
    """The tenant identity a parsed completion spec bills to: its
    adapter name, or ``"_base"`` for base-model traffic (the underscore
    keeps it out of the valid adapter-name space)."""
    return spec.get("adapter") or "_base"


def summary_payload(fleet, status: str) -> dict:
    """The single summary shape for JSON responses AND the SSE final
    done-event: ``trace_id`` here is what lets a client hand the id
    straight to ``GET /debug/trace``."""
    return {
        "status": status,
        "tokens": [int(t) for t in fleet.tokens],
        "prompt_len": int(fleet.prompt_ids.shape[1]),
        "failovers": fleet.failovers,
        "replica_trail": list(fleet.replica_trail),
        "trace_id": fleet.trace_id,
    }


def completion_result(fleet, retry_after_s: float):
    """Terminal (code, payload, extra_headers) for a FINISHED
    non-streaming completion — including the adapter-bank-full
    residency-pressure 503 special case. Shared by both front ends."""
    if (fleet.status is RequestStatus.FAILED
            and isinstance(fleet.error, AdapterBankFull)):
        # Residency pressure, not a server fault: every bank row was
        # pinned by an in-flight stream at admission time. Structured
        # 503 so clients can back off and retry.
        payload = summary_payload(fleet, "failed")
        payload["error"] = "adapter_bank_full"
        payload["detail"] = str(fleet.error)
        return 503, payload, {"Retry-After": f"{retry_after_s:g}"}
    code, status = _STATUS_HTTP[fleet.status]
    payload = summary_payload(fleet, status)
    if code != 200:
        payload["error"] = (str(fleet.error)
                            if fleet.error is not None else status)
    return code, payload, {}


class ServingGateway:
    """HTTP server over a replica set (or a single engine, auto-wrapped).

    Usage::

        gw = ServingGateway(replica_set, config=GatewayConfig(port=0))
        gw.start()
        ...  # POST to gw.url + "/v1/completions"
        gw.shutdown(drain=True)

    Also a context manager (``start`` on enter, drain-shutdown on exit).
    """

    def __init__(self, replicas, *, config: Optional[GatewayConfig] = None,
                 stats: Optional[GatewayStats] = None, accelerator=None):
        if isinstance(replicas, ServingEngine):
            replicas = ReplicaSet([replicas])
        if not isinstance(replicas, ReplicaSet):
            raise TypeError(
                f"replicas must be a ReplicaSet or ServingEngine "
                f"(got {type(replicas).__name__})")
        self.replica_set = replicas
        self.config = config if config is not None else GatewayConfig()
        if stats is None and accelerator is not None:
            stats = getattr(accelerator, "gateway_stats", None)
        self.stats = stats if stats is not None else GatewayStats()
        # Tenant policy (control plane): built once from config; both
        # front ends consult them through submit_or_error only.
        from .control import FairShareAdmission, TenantRateLimiter

        self.rate_limiter = None
        if self.config.rate_limits:
            self.rate_limiter = TenantRateLimiter(
                self.config.rate_limits,
                burst_s=self.config.rate_limit_burst_s)
        self.fair_share = None
        if self.config.fair_share_weights is not None:
            self.fair_share = FairShareAdmission(
                self.config.fair_share_weights,
                pressure=self.config.fair_share_pressure)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self._shutdown_lock = threading.Lock()
        self._conn_slots = threading.BoundedSemaphore(
            self.config.max_connections)
        # Graph-capture accounting for /metrics: each engine's watcher
        # counts its own captures, so the gateway reads the fleet's totals
        # (retired engines included) against a baseline taken in start().
        self._capture_base: Optional[tuple] = None

    # -- lifecycle --------------------------------------------------------
    def start(self):
        """Bind and serve in a daemon thread (idempotent). With
        ``config.port == 0`` the OS picks the port; read it back from
        :attr:`port` / :attr:`url`. Which front end binds is
        ``config.server``; either way :attr:`_server` duck-types the
        ``shutdown()`` / ``server_close()`` / ``server_address`` surface
        the lifecycle methods drive."""
        if self._server is not None:
            return
        if self._capture_base is None:
            self._capture_base = self.replica_set.capture_totals()
        if self.config.server == "asyncio":
            from .gateway_aio import AsyncioGatewayServer

            self._server = AsyncioGatewayServer(self)
            self._thread = self._server.thread
            return
        handler = type("GatewayHandler", (_Handler,), {"gateway": self})
        self._server = ThreadingHTTPServer(
            (self.config.host, self.config.port), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serving-gateway",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("gateway not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def ready(self) -> bool:
        """The ``/readyz`` condition: accepting AND >= 1 healthy replica."""
        return not self._draining and self.replica_set.ready

    def drain(self):
        """Stop taking new work (readyz 503, completions 503); in-flight
        streams keep running. ``shutdown`` completes the exit."""
        self._draining = True
        self.replica_set.drain()

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Graceful exit: drain, wait (bounded by ``drain_grace_s``) for
        in-flight HTTP exchanges, stop the listener, shut the replicas
        down. ``drain=False`` skips the waiting and cancels in-flight work."""
        with self._shutdown_lock:
            self._draining = True
            if drain:
                self.replica_set.drain()
                deadline = time.monotonic() + self.config.drain_grace_s
                while (self.stats.summary()["http_inflight"] > 0
                        and time.monotonic() < deadline):
                    time.sleep(0.01)
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()
                self._server = None
                self._thread = None
            self.replica_set.shutdown(drain=drain, timeout=timeout)

    def install_signal_handlers(self, signals=(signal.SIGTERM,
                                               signal.SIGINT)) -> bool:
        """Wire graceful drain to process signals (SIGTERM is what k8s and
        cloud preemption notices deliver). Returns False — without
        installing — when not on the main thread, where CPython forbids
        ``signal.signal``."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _handle(signum, frame):
            # The handler must not block: drain flips flags, the real
            # shutdown runs on its own thread.
            threading.Thread(target=self.shutdown, kwargs={"drain": True},
                             name="gateway-drain", daemon=True).start()

        for s in signals:
            signal.signal(s, _handle)
        return True

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- admission (shared by both front ends) ----------------------------
    def pressure_retry_after(self, spec: dict) -> Optional[float]:
        """Projected-pressure shed decision: a ``Retry-After`` in seconds
        when this completion should be 429'd, else None (admit).

        Sheds only when (a) the fleet's least-loaded paged pool cannot
        cover this request's worst-case page demand on top of what is
        already admitted + queued, AND (b) pages have been *observed*
        draining but too slowly to clear that deficit within
        ``shed_wait_s``. Rule (b) means a cold fleet (nothing freed yet)
        or a dense fleet never sheds — queue-depth 429s and deadline
        408s keep covering those.
        """
        cfg = self.config
        if not cfg.shed_projected_pressure:
            return None
        rs = self.replica_set
        total = int(spec["prompt_ids"].shape[-1]) + int(spec["max_new_tokens"])
        deficit = rs.projected_page_deficit(total)
        if deficit <= 0:
            return None
        rate = rs.page_drain_rate()
        if rate <= 0 or deficit <= rate * cfg.shed_wait_s:
            return None
        return clamp_retry_after(cfg, deficit / rate)

    def submit_or_error(self, spec: dict, trace_id: str, on_token=None):
        """Admit one parsed completion spec: ``(fleet, None)`` on success,
        ``(None, (code, payload, extra_headers))`` on any refusal —
        rate-limit 429, fair-share 429, projected-pressure 429,
        queue-full 429, unknown-adapter 404, no-healthy-replica 503, or
        invalid-parameter 400. The single admission path both front ends
        share, so backpressure semantics cannot drift between them.

        Tenant policy runs first, cheapest-check-first: the token-bucket
        rate limit (pure arithmetic, its Retry-After is the bucket's own
        refill time clamped through :func:`clamp_retry_after` like every
        other shed), then weighted fair share (a successful acquire is
        released exactly once via the fleet request's done callback —
        including failure/cancel terminals), then the fleet-pressure and
        submit paths exactly as before."""
        cfg = self.config
        retry_headers = {"Retry-After": f"{cfg.retry_after_s:g}"}
        tenant = tenant_of(spec)
        if self.rate_limiter is not None:
            refill_in = self.rate_limiter.admit(tenant)
            if refill_in is not None:
                self.stats.record_rate_limit_shed()
                return None, (
                    429, {"error": "rate_limited",
                          "detail": f"tenant {tenant!r} is over its "
                                    "request rate; retry later",
                          "tenant": tenant},
                    {"Retry-After":
                     f"{clamp_retry_after(cfg, refill_in):g}"})
        acquired = False
        if self.fair_share is not None:
            capacity = self.replica_set.admission_capacity()
            if not self.fair_share.try_acquire(tenant, capacity):
                self.stats.record_fair_share_shed()
                return None, (
                    429, {"error": "fair_share_exceeded",
                          "detail": f"tenant {tenant!r} is over its "
                                    "weighted share of in-flight streams "
                                    "under fleet pressure; retry later",
                          "tenant": tenant},
                    retry_headers)
            acquired = True

        def _refuse(resp):
            # Any refusal past a successful fair-share acquire returns
            # the tenant's in-flight slot — no leaked shares.
            if acquired:
                self.fair_share.release(tenant)
            return None, resp

        retry_in = self.pressure_retry_after(spec)
        if retry_in is not None:
            self.stats.record_pressure_shed()
            return _refuse((
                429, {"error": "projected KV page pressure: admitted and "
                               "queued work exceeds pool headroom; "
                               "retry later"},
                {"Retry-After": f"{retry_in:g}"}))
        try:
            fleet = self.replica_set.submit(
                spec["prompt_ids"],
                max_new_tokens=spec["max_new_tokens"],
                seed=spec["seed"], timeout=spec["timeout"],
                ignore_eos=spec["ignore_eos"],
                adapter=spec["adapter"],
                priority=spec.get("priority"),
                trace_id=trace_id,
                on_token=on_token)
        except QueueFull:
            return _refuse((429, {"error": "all replicas saturated; "
                                           "retry later"}, retry_headers))
        except LookupError as e:
            return _refuse((404, {"error": "unknown_adapter",
                                  "detail": str(e)}, {}))
        except RuntimeError as e:
            return _refuse((503, {"error": f"no healthy replica: {e}"},
                            retry_headers))
        except ValueError as e:
            return _refuse((400, {"error": str(e)}, {}))
        except BaseException:
            if acquired:
                self.fair_share.release(tenant)
            raise
        if acquired:
            fleet.add_done_callback(
                lambda _f, fs=self.fair_share, t=tenant: fs.release(t))
        return fleet, None

    # -- metrics ----------------------------------------------------------
    def capture_summary(self) -> dict:
        """Graph captures since :meth:`start` across every engine the fleet
        held (a rebuilt replica's warmup captures count; retired engines'
        stay counted): ``{"capture_events", "capture_secs"}``."""
        events, secs = self.replica_set.capture_totals()
        base_events, base_secs = self._capture_base or (0, 0.0)
        return {"capture_events": events - base_events,
                "capture_secs": round(max(0.0, secs - base_secs), 6)}

    def metrics_text(self) -> str:
        """The ``/metrics`` body: Prometheus text exposition (version
        0.0.4) of fleet-merged engine counters (gauges PLUS real
        cumulative-bucket latency histograms), router health/failover
        counters, the fleet's graph-capture counters, and the gateway's
        HTTP counters. Every family carries ``# HELP``/``# TYPE`` —
        ``observability.promlint`` keeps this scrape-clean in tests."""
        lines = []

        def emit(name, value, mtype="gauge", help_=None):
            lines.append(f"# HELP {name} "
                         + (help_ or _METRIC_HELP.get(
                             name, f"accelerate-tpu serving-stack {mtype}.")))
            lines.append(f"# TYPE {name} {mtype}")
            v = float(value)
            lines.append(f"{name} {int(v) if v == int(v) else v}")

        merged = self.replica_set.merged_stats()
        for k, v in self.replica_set.fleet_metrics().items():
            if k.startswith(("adapter/", "priority/")):
                continue  # re-emitted below as properly labeled series
            emit(f"accelerate_tpu_serving_{k}", v)
        # Latency distributions: the *_ms summary gauges above keep their
        # names; the histogram twin gets a _hist-suffixed family so the
        # two never collide in one exposition.
        for hname, snap in sorted(merged.histograms().items()):
            fam = f"accelerate_tpu_serving_{hname}_hist"
            lines.append(f"# HELP {fam} Fleet-wide distribution of "
                         f"{hname} (cumulative buckets, ms).")
            lines.append(f"# TYPE {fam} histogram")
            for bound, cum in snap["cumulative"]:
                le = "+Inf" if bound == "+Inf" else str(float(bound))
                lines.append(f'{fam}_bucket{{le="{le}"}} {cum}')
            s = float(snap["sum"])
            lines.append(f"{fam}_sum {int(s) if s == int(s) else s}")
            lines.append(f"{fam}_count {snap['count']}")
        per_adapter = merged.per_adapter()
        if per_adapter:
            counters = sorted(next(iter(per_adapter.values())))
            for c in counters:
                lines.append(
                    f"# HELP accelerate_tpu_serving_adapter_{c} "
                    f"Per-adapter {c} across the fleet.")
                lines.append(
                    f"# TYPE accelerate_tpu_serving_adapter_{c} counter")
                for name in sorted(per_adapter):
                    lines.append(
                        f'accelerate_tpu_serving_adapter_{c}'
                        f'{{adapter="{name}"}} {per_adapter[name][c]}')
        per_priority = merged.per_priority()
        if per_priority:
            counters = sorted(next(iter(per_priority.values())))
            for c in counters:
                lines.append(
                    f"# HELP accelerate_tpu_serving_priority_{c} "
                    f"Per-priority (traffic class) {c} across the fleet — "
                    "the class each engine's priority policy schedules "
                    "and preempts by.")
                lines.append(
                    f"# TYPE accelerate_tpu_serving_priority_{c} counter")
                for name in sorted(per_priority):
                    lines.append(
                        f'accelerate_tpu_serving_priority_{c}'
                        f'{{priority="{name}"}} {per_priority[name][c]}')
        if self._capture_base is not None:
            cs = self.capture_summary()
            emit("accelerate_tpu_graph_capture_events_total",
                 cs["capture_events"], "counter",
                 help_="CUDA graph captures (CPU: new step signatures) of "
                       "the fleet's engines since the gateway started, "
                       "retired engines included (0 growth = no capture "
                       "after warmup).")
            emit("accelerate_tpu_graph_capture_seconds_total",
                 cs["capture_secs"], "counter",
                 help_="Wall seconds spent capturing those graphs.")
            emit("accelerate_tpu_xla_compilation_cache_hits_total", 0,
                 "counter",
                 help_="Kept for scrape compatibility with the JAX "
                       "gateway: the PyTorch fleet has no compilation "
                       "cache, so this stays 0.")
        for k, v in self.stats.summary().items():
            emit(f"accelerate_tpu_gateway_{k}", v)
        lines.append(
            "# HELP accelerate_tpu_gateway_responses_total "
            "HTTP responses by route and status code.")
        lines.append(
            "# TYPE accelerate_tpu_gateway_responses_total counter")
        for (route, code), n in sorted(self.stats.by_route().items()):
            lines.append(
                'accelerate_tpu_gateway_responses_total'
                f'{{route="{route}",code="{code}"}} {n}')
        return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    """Per-connection handler; ``gateway`` is injected as a class
    attribute by ``ServingGateway.start``."""

    gateway: ServingGateway = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"
    # Quieten the default per-request stderr lines; errors still surface
    # through status codes and /metrics.
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- plumbing ---------------------------------------------------------
    def _send_json(self, code: int, payload: dict, route: str,
                   extra_headers: Optional[dict] = None,
                   body_bytes_in: int = 0,
                   trace_id: Optional[str] = None):
        if trace_id is not None:
            # Correlation id rides both channels: the JSON body (clients
            # that log payloads) and the X-Request-Id header (proxies).
            payload.setdefault("trace_id", trace_id)
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if trace_id is not None:
            self.send_header("X-Request-Id", trace_id)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        self.gateway.stats.record_response(route, code,
                                           body_bytes=body_bytes_in)

    def _send_text(self, code: int, text: str, route: str,
                   content_type: str = "text/plain; charset=utf-8",
                   extra_headers: Optional[dict] = None):
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        self.gateway.stats.record_response(route, code)

    def _retry_after(self) -> dict:
        return {"Retry-After": f"{self.gateway.config.retry_after_s:g}"}

    # -- GET --------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (http.server naming)
        gw = self.gateway
        parsed = urlparse(self.path)
        path = parsed.path
        if not self._conn_enter(path):
            return
        try:
            if path == "/healthz":
                self._send_text(200, "ok\n", "/healthz")
            elif path == "/readyz":
                if gw.ready:
                    self._send_text(200, "ready\n", "/readyz")
                else:
                    if gw.draining:
                        body = "draining\n"
                    else:
                        fm = gw.replica_set.fleet_metrics()
                        looped = int(fm.get("replicas_crash_loop", 0))
                        body = ("no healthy replica"
                                + (f" ({looped} crash-looped)" if looped
                                   else "") + "\n")
                    self._send_text(503, body, "/readyz",
                                    extra_headers=self._retry_after())
            elif path == "/metrics":
                self._send_text(200, gw.metrics_text(), "/metrics",
                                content_type="text/plain; version=0.0.4; "
                                             "charset=utf-8")
            elif path == "/debug/trace":
                self._debug_trace(parse_qs(parsed.query))
            else:
                self._send_json(404, {"error": "not found"}, path)
        finally:
            self._conn_exit()

    def _debug_trace(self, query: dict):
        """``GET /debug/trace`` — the whole fleet's buffered spans as one
        Chrome-trace JSON; ``?id=<trace_id>`` narrows to one request's
        timeline (404 when no replica buffered a span for that id)."""
        route = "/debug/trace"
        raw = (query.get("id") or [None])[0]
        tid = None
        if raw is not None:
            tid = clean_trace_id(raw)
            if tid is None:
                self._send_json(400, {"error": "invalid trace id"}, route)
                return
        trace = self.gateway.replica_set.chrome_trace(tid)
        if tid is not None and not any(
                ev.get("ph") != "M" for ev in trace["traceEvents"]):
            self._send_json(404, {"error": "trace not found",
                                  "trace_id": tid}, route)
            return
        self._send_text(200, json.dumps(trace), route,
                        content_type="application/json")

    # -- POST -------------------------------------------------------------
    def do_POST(self):  # noqa: N802
        gw = self.gateway
        if self.path != "/v1/completions":
            self._send_json(404, {"error": "not found"}, self.path)
            return
        route = "/v1/completions"
        if not self._conn_enter(route):
            return
        # Minted before anything can fail so even a 4xx/5xx body carries
        # a correlation id (the client's own X-Request-Id when it sent a
        # well-formed one).
        trace_id = (clean_trace_id(self.headers.get("X-Request-Id"))
                    or new_trace_id())
        try:
            if gw.draining:
                self._send_json(503, {"error": "gateway draining"}, route,
                                extra_headers=self._retry_after(),
                                trace_id=trace_id)
                return
            try:
                body, nbytes = self._read_body()
                spec = self._parse_completion(body)
            except _BadRequest as e:
                code = 413 if "max_body_bytes" in str(e) else 400
                self._send_json(code, {"error": str(e)}, route,
                                trace_id=trace_id)
                return
            self._run_completion(spec, route, nbytes, trace_id)
        finally:
            self._conn_exit()

    def _read_body(self) -> tuple[dict, int]:
        cfg = self.gateway.config
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            raise _BadRequest("Content-Length required") from None
        if length > cfg.max_body_bytes:
            raise _BadRequest(
                f"request body {length} bytes exceeds max_body_bytes "
                f"({cfg.max_body_bytes})")
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise _BadRequest(f"invalid JSON: {e}") from None
        if not isinstance(body, dict):
            raise _BadRequest("request body must be a JSON object")
        return body, length

    def _parse_completion(self, body: dict) -> dict:
        return parse_completion(body, self.gateway.config)

    def _run_completion(self, spec: dict, route: str, nbytes: int,
                        trace_id: str):
        gw = self.gateway
        stream = spec.pop("stream")
        token_q: Optional[queue.Queue] = queue.Queue() if stream else None
        fleet, err = gw.submit_or_error(
            spec, trace_id, on_token=token_q.put if stream else None)
        if err is not None:
            code, payload, headers = err
            self._send_json(code, payload, route, extra_headers=headers,
                            body_bytes_in=nbytes, trace_id=trace_id)
            return
        if stream:
            self._stream_sse(fleet, token_q, route, nbytes)
        else:
            fleet.wait()  # bounded by the per-request deadline when set
            code, payload, headers = completion_result(
                fleet, gw.config.retry_after_s)
            self._send_json(code, payload, route, extra_headers=headers,
                            body_bytes_in=nbytes, trace_id=trace_id)

    def _stream_sse(self, fleet, token_q: queue.Queue, route: str,
                    nbytes: int):
        """One SSE event per token as the engine commits it; a final
        summary event carries the terminal status (and failover count) so
        clients can tell a complete stream from a truncated one. A broken
        client socket cancels the request — its slot frees at the next
        scheduler pass instead of decoding into the void. With
        ``sse_heartbeat_s`` set, a ``: ping`` comment frame goes out on
        any stream idle past it (deep PREFILLING backlogs) so
        intermediaries don't sever long-queued streams."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.send_header("X-Request-Id", fleet.trace_id)
        self.end_headers()
        self.close_connection = True
        heartbeat = self.gateway.config.sse_heartbeat_s
        last_write = time.monotonic()
        sent = 0
        self.gateway.stats.stream_enter()
        try:
            while True:
                try:
                    tok = token_q.get(timeout=0.05)
                except queue.Empty:
                    if fleet.done and token_q.empty():
                        break
                    if (heartbeat is not None
                            and time.monotonic() - last_write >= heartbeat):
                        self.wfile.write(b": ping\n\n")
                        self.wfile.flush()
                        last_write = time.monotonic()
                    continue
                self.wfile.write(
                    f"data: {json.dumps({'token': int(tok)})}\n\n".encode())
                self.wfile.flush()
                last_write = time.monotonic()
                sent += 1
            code, status = _STATUS_HTTP[fleet.status]
            final = summary_payload(fleet, status)
            final["done"] = True
            if fleet.status is not RequestStatus.COMPLETED:
                final["error"] = (str(fleet.error)
                                  if fleet.error is not None else status)
            self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            fleet.cancel()
            code = 499  # client closed; nothing more can be written
        finally:
            self.gateway.stats.stream_exit()
        self.gateway.stats.record_response(route, code, body_bytes=nbytes)
        self.gateway.stats.record_stream(sent)

    # -- connection cap ----------------------------------------------------
    def _conn_enter(self, route: str) -> bool:
        """Take an in-flight slot; refuse with 503 when the cap is hit
        (without blocking — the admission queues are the real wait)."""
        if not self.gateway._conn_slots.acquire(blocking=False):
            self.gateway.stats.record_conn_rejection()
            try:
                self._send_json(503, {"error": "connection limit reached"},
                                route, extra_headers=self._retry_after())
            except (BrokenPipeError, ConnectionResetError):
                pass
            return False
        self.gateway.stats.inflight_enter()
        return True

    def _conn_exit(self):
        self.gateway.stats.inflight_exit()
        self.gateway._conn_slots.release()
