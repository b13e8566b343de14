"""The profiler's trace of a sub-window, reduced to what the metrics read.

``torch.profiler`` records the card's kernels (through CUPTI) and the host's
operators; its Chrome trace is written to a temporary file, read back into
a :class:`Trace` and deleted. Kernels map to the host operator that
launched them by the trace's ``External id``, and to the runtime call that
launched them (a kernel launch or a CUDA graph's) by ``correlation``.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Optional

#: Event categories that occupy the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host categories an idle gap is named by.
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                   "python_function")


def profiler():
    """A ``torch.profiler.profile`` of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read(prof) -> "Trace":
    """The :class:`Trace` of a finished profiler."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return Trace(events)


class Trace:
    """Device and host intervals of one traced window, in microseconds."""

    def __init__(self, events: list):
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((e for e in complete if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda e: e["ts"])
        self.host = [e for e in complete if e.get("cat") in HOST_CATEGORIES]
        host_ts = [e["ts"] for e in self.host] + [e["ts"] + e["dur"] for e in self.host]
        dev_ts = [e["ts"] for e in self.device] + [e["ts"] + e["dur"] for e in self.device]
        stamps = host_ts + dev_ts
        self.start = min(stamps) if stamps else 0.0
        self.end = max(stamps) if stamps else 0.0

    # -- the window -----------------------------------------------------
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _busy_intervals(self) -> list:
        merged = []
        for e in self.device:
            a, b = e["ts"], e["ts"] + e["dur"]
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        return sum(b - a for a, b in self._busy_intervals()) / 1e6

    def idle_share(self) -> Optional[float]:
        """The window's share in which no operation ran, in percent."""
        window = self.window_s()
        if not self.device or window <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / window)

    def idle_gaps(self) -> list:
        """``(start, end)`` of each stretch with nothing on the device."""
        gaps, at = [], self.start
        for a, b in self._busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    # -- kernels ----------------------------------------------------------
    def kernels(self) -> list:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def kernels_named(self, *fragments: str) -> list:
        """Kernels whose name holds one of ``fragments``."""
        return [e for e in self.kernels() if any(f in e["name"] for f in fragments)]

    def kernels_of_op(self, op_name: str) -> list:
        """Kernels launched by host operators named ``op_name`` (innermost)."""
        ids = {e.get("args", {}).get("External id") for e in self.host
               if e.get("cat") == "cpu_op" and e["name"] == op_name}
        ids.discard(None)
        return [e for e in self.kernels() if e.get("args", {}).get("External id") in ids]

    @staticmethod
    def total_us(events: list) -> float:
        return sum(e["dur"] for e in events)

    # -- the breakdown of the result line -------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the host operation under way when each gap began."""
        ops = collections.Counter()
        for e in self.device:
            ops[e["name"]] += e["dur"] / 1e6
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        gaps = collections.Counter()
        for a, b in self.idle_gaps():
            gaps[self._host_at(host, starts, a)] += (b - a) / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}

    @staticmethod
    def _host_at(host, starts, t) -> str:
        """The shortest host range that covers ``t``."""
        best = None
        i = bisect.bisect_right(starts, t)
        for e in host[max(0, i - 2000):i]:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best is not None else "(no host range traced)"
