"""Per-replica flight recorder: the serving engine's black box.

Counterpart of ``accelerate_tpu/observability/flight_recorder.py``.

Keeps the last N *structured* lifecycle events — admissions,
preemptions, pool exhaustion, adapter loads, graph captures, kill
injections, fatal errors — in a bounded deque, and renders them as a
postmortem dict on demand. The engine auto-captures a dump when its run
loop dies (``kill()`` or an engine fatal), so the router's failover
report carries *what the replica was doing when it died* instead of just
a stack trace.

Events are mirrored as instant events into the replica's
:class:`~accelerate_tpu_torch.observability.tracing.Tracer` (when one is
attached), so a Chrome-trace export shows the black-box events on the
same timeline as the request spans.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .tracing import Tracer

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded (drop-oldest) recorder of structured replica events.

    Recording takes one short lock (events are orders of magnitude rarer
    than decode ticks — admissions, preemptions, compiles — so a deque
    under a lock is plenty); reading snapshots under the same lock.
    """

    def __init__(self, capacity: int = 256, name: str = "replica",
                 tracer: Optional[Tracer] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.name = name
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tracer = tracer
        self._dropped = 0

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event; drops the oldest when full."""
        ev = {"ts": time.monotonic(), "kind": kind}
        if fields:
            ev.update(fields)
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)
        if self._tracer is not None:
            self._tracer.instant(kind, trace_id=fields.get("trace_id"),
                                 cat="flight", args=fields or None)

    def snapshot(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        if last is not None:
            events = events[-last:]
        return events

    def dump(self) -> Dict[str, Any]:
        """Postmortem dict: recorder identity + the buffered events."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        return {
            "name": self.name,
            "captured_at": time.time(),
            "captured_monotonic": time.monotonic(),
            "capacity": self.capacity,
            "dropped": dropped,
            "events": events,
        }

    def dump_json(self, path: str) -> str:
        """Write :meth:`dump` to ``path`` (values coerced via ``repr`` if
        not JSON-serializable); returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.dump(), f, default=repr)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
