"""Request-scoped tracing: trace ids, spans, and Chrome-trace export.

Counterpart of ``accelerate_tpu/observability/tracing.py``.

The serving stack's metrics (``serving.metrics``) answer "how is the
fleet doing on average"; this module answers "where did *this* request's
latency go". A ``trace_id`` is minted at the gateway (or accepted from
the client via ``X-Request-Id``), carried on ``Request``/``FleetRequest``
through every lifecycle edge, and each edge drops a span into a
:class:`Tracer`:

* ``queue_wait`` — admission-queue residency (submit → slot assignment)
* ``prefill_chunk`` — each fixed-shape prefill chunk, with offset/backlog
* ``decode_tick`` / ``itl`` — every decode step's wall time, per request
* instant events — prefix-cache hits/aliases, page preemptions,
  speculation accept counts, retirements, failover hops

Spans land in a **lock-light per-thread ring buffer**: the hot path is a
single list-index store by the owning thread (no locks, no allocation
beyond one tuple), bounded with drop-oldest semantics so a tracer can
stay enabled in production indefinitely. Export is Chrome-trace /
Perfetto JSON (``chrome://tracing``, https://ui.perfetto.dev) via
:meth:`Tracer.chrome_trace` / :meth:`Tracer.dump`, surfaced as
``engine.dump_trace(path)``, gateway ``GET /debug/trace?id=`` and
``accelerate-tpu serve --trace-dir``.

Timestamps are ``time.monotonic()`` microseconds: within one process all
tracers share the clock, so per-replica traces merge into one aligned
fleet timeline (:func:`merge_chrome_traces`).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Tracer",
    "TraceSpan",
    "new_trace_id",
    "clean_trace_id",
    "merge_chrome_traces",
    "validate_chrome_trace",
]

#: Cap on client-supplied X-Request-Id values.
TRACE_ID_MAX_LEN = 128

_TRACE_ID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:")


def new_trace_id() -> str:
    """Mint a fresh 16-hex-char trace id."""
    return uuid.uuid4().hex[:16]


def clean_trace_id(raw: Any) -> Optional[str]:
    """Sanitize a client-supplied trace id (``X-Request-Id`` header).

    Returns the id if it is a non-empty string of reasonable length over
    ``[A-Za-z0-9._:-]``, else ``None`` (caller mints a fresh one).
    """
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    if not raw or len(raw) > TRACE_ID_MAX_LEN:
        return None
    if not all(c in _TRACE_ID_CHARS for c in raw):
        return None
    return raw


class _Ring:
    """Single-writer bounded ring with drop-oldest semantics.

    The owning thread appends lock-free (one index store + increment);
    readers on other threads take a best-effort snapshot — records are
    immutable tuples, so a concurrent reader can miss or double-see the
    entry being overwritten but never observes a torn record. ``start``
    is a logical watermark so :meth:`Tracer.clear` can discard history
    without touching the writer's buffer.
    """

    __slots__ = ("buf", "cap", "n", "start")

    def __init__(self, cap: int):
        self.cap = cap
        self.buf: List[Optional[tuple]] = [None] * cap
        self.n = 0
        self.start = 0

    def append(self, rec: tuple) -> None:
        n = self.n
        self.buf[n % self.cap] = rec
        self.n = n + 1

    def snapshot(self) -> List[tuple]:
        n = self.n
        lo = max(self.start, n - self.cap)
        buf, cap = self.buf, self.cap
        out = []
        for i in range(lo, n):
            rec = buf[i % cap]
            if rec is not None:
                out.append(rec)
        return out


class TraceSpan:
    """Context manager emitting one complete span on exit.

    Returned by :meth:`Tracer.span`; ``args`` may be extended inside the
    ``with`` block via :meth:`note` (e.g. recording a hit count that is
    only known at the end of the timed region).
    """

    __slots__ = ("_tracer", "name", "cat", "trace_id", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: Optional[str], args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.args = args
        self._t0 = 0.0

    def note(self, **fields: Any) -> None:
        if self.args is None:
            self.args = {}
        self.args.update(fields)

    def __enter__(self) -> "TraceSpan":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.emit(self.name, self._t0,
                          time.monotonic() - self._t0,
                          trace_id=self.trace_id, cat=self.cat,
                          args=self.args)


_PID_LOCK = threading.Lock()
_NEXT_PID = [1]


def _next_pid() -> int:
    with _PID_LOCK:
        pid = _NEXT_PID[0]
        _NEXT_PID[0] += 1
    return pid


class Tracer:
    """Bounded, lock-light span sink with Chrome-trace export.

    One tracer per replica (engine) or per training session. Each
    emitting thread gets its own :class:`_Ring` of ``capacity`` records;
    the registry lock is taken only on a thread's *first* emit. With
    ``enabled=False`` every emit is a cheap early return, so call sites
    never need their own guards.

    Record layout (immutable tuple):
    ``(t0_monotonic_s, dur_s_or_None, name, cat, trace_id, args)`` —
    ``dur_s=None`` marks an instant event.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 name: str = "trace"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.name = name
        self.pid = _next_pid()
        self._rings: Dict[int, _Ring] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- hot path ------------------------------------------------------
    def emit(self, name: str, t0: float, dur_s: Optional[float] = None, *,
             trace_id: Optional[str] = None, cat: str = "serving",
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record one span (``dur_s`` seconds) or instant (``dur_s=None``)."""
        if not self.enabled:
            return
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = self._register_ring()
        ring.append((t0, dur_s, name, cat, trace_id, args))

    def instant(self, name: str, *, trace_id: Optional[str] = None,
                cat: str = "serving",
                args: Optional[Dict[str, Any]] = None) -> None:
        self.emit(name, time.monotonic(), None, trace_id=trace_id,
                  cat=cat, args=args)

    def span(self, name: str, *, trace_id: Optional[str] = None,
             cat: str = "serving",
             args: Optional[Dict[str, Any]] = None) -> TraceSpan:
        return TraceSpan(self, name, cat, trace_id, args)

    def _register_ring(self) -> _Ring:
        ring = _Ring(self.capacity)
        self._local.ring = ring
        with self._lock:
            if len(self._rings) >= 32:
                # Short-lived emitters (e.g. per-connection HTTP handler
                # threads calling submit) would otherwise leak one ring
                # per dead thread; prune rings whose thread is gone.
                live = {t.ident for t in threading.enumerate()}
                for tid in [t for t in self._rings if t not in live]:
                    del self._rings[tid]
            self._rings[threading.get_ident()] = ring
        return ring

    # -- export --------------------------------------------------------
    def events(self, trace_id: Optional[str] = None) -> List[tuple]:
        """Snapshot of buffered records (optionally filtered), as
        ``(tid, t0, dur_s, name, cat, trace_id, args)`` sorted by t0."""
        with self._lock:
            rings = list(self._rings.items())
        out = []
        for tid, ring in rings:
            for rec in ring.snapshot():
                if trace_id is None or rec[4] == trace_id:
                    out.append((tid,) + rec)
        out.sort(key=lambda r: r[1])
        return out

    def chrome_trace(self, trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON dict for the buffered spans."""
        evs: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": self.name},
        }]
        for tid, t0, dur, name, cat, tr, args in self.events(trace_id):
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "pid": self.pid, "tid": tid,
                "ts": round(t0 * 1e6, 3),
            }
            a = dict(args) if args else {}
            if tr is not None:
                a["trace_id"] = tr
            if a:
                ev["args"] = a
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            evs.append(ev)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def dump(self, path: str, trace_id: Optional[str] = None) -> str:
        """Write the Chrome-trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(trace_id), f)
        return path

    def clear(self) -> None:
        """Discard buffered spans (e.g. after warmup traffic)."""
        with self._lock:
            rings = list(self._rings.values())
        for ring in rings:
            ring.start = ring.n

    def __len__(self) -> int:
        with self._lock:
            rings = list(self._rings.values())
        return sum(max(0, min(r.n - r.start, r.cap)) for r in rings)


def merge_chrome_traces(traces: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-replica Chrome-trace dicts into one fleet timeline.

    Tracers in one process share the monotonic clock and carry distinct
    ``pid`` lanes, so concatenating event lists yields an aligned
    multi-process view (replica A's prefill next to replica B's resumed
    continuation after a failover).
    """
    evs: List[Dict[str, Any]] = []
    for t in traces:
        evs.extend(t.get("traceEvents", ()))
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Dict[str, Any]) -> List[str]:
    """Structural lint of a Chrome-trace dict; returns problems (empty
    list = valid). Used by tests and by ``/debug/trace`` consumers that
    want a cheap sanity check without loading the Perfetto UI."""
    problems: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        for key in ("name", "pid", "tid", "ts"):
            if key not in ev:
                problems.append(f"event {i} ({ev.get('name')}): missing {key}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')}): bad dur {dur!r}")
    return problems
