"""The harness: finds a cell's files by name, runs its traffic kind, reads
its metrics and prints the result line.

Everything particular to one configuration, cell, traffic kind or
per-layer metric is a file of its own, found by name under the benchmark's
directory:

* ``configs/<config>.json``: the configuration as it is run;
* ``workloads/<cell>.json``: the cell (config, traffic kind, its
  parameters, chips, why, the limits of its checks);
* ``traffic/<kind>.py``: a module with ``run(cell)``, which drives the
  program and fills in the :class:`Cell`;
* ``metrics/<metric>.py``: a module with ``read(cell)``, which returns
  the metric's value or None when it finds nothing to read.

Which metrics a cell reports comes from ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Optional

#: Top-level module names no run may hold, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu")


class Refused(RuntimeError):
    """A run that must print no result (no card, a forbidden import)."""


def process_seconds() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One run of one cell: what the traffic module is given, and what it
    and the metric readers fill in."""

    name: str
    spec: dict                      # workloads/<cell>.json
    config: dict                    # configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: Any = None              # torch.device
    # Filled by the traffic module.
    end_to_end: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    device_trace: Any = None        # trace.Trace of the traced sub-window
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: dict = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> dict:
        return self.spec["params"]

    def note(self, text: str):
        """A line for standard error (not part of the result)."""
        print(f"[portbench] {text}", file=sys.stderr, flush=True)


class Bench:
    """The benchmark rooted at ``bench_dir`` (the directory of
    ``BENCHMARK.json``'s ``paths``), described by ``benchmark``."""

    def __init__(self, bench_dir: Path, benchmark: dict):
        self.dir = Path(bench_dir)
        self.benchmark = benchmark

    @classmethod
    def at(cls, root: Path, subdir: str = "portbench") -> "Bench":
        return cls(Path(root) / subdir, _read_json(Path(root) / "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        entry = next((w for w in self.benchmark["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        spec = _read_json(self.dir / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if spec[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json says {key}={spec[key]!r}, "
                                 f"BENCHMARK.json {entry[key]!r}")
        return spec

    def config(self, name: str) -> dict:
        entry = next(c for c in self.benchmark["configs"] if c["name"] == name)
        return _read_json(self.dir.parent / entry["file"])

    def traffic(self, kind: str):
        return _module(self.dir / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")

    def reader(self, metric: str):
        return _module(self.dir / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_"))

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        ones: entries that list it, or list no cells."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.benchmark[kind] if cell in m.get("workloads", [cell])]


def require_card(chips: int):
    """Raise :class:`Refused` unless this machine has ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def make_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda", overrides: Optional[dict] = None) -> Cell:
    """The :class:`Cell` of one run. ``overrides`` (the tests': a size a
    CPU holds) replaces keys of ``config`` and of ``params``."""
    import torch

    spec = bench.workload(name)
    config = bench.config(spec["config"])
    if overrides:
        config = {**config, **overrides.get("config", {})}
        spec = {**spec, "params": {**spec["params"], **overrides.get("params", {})}}
    return Cell(name=name, spec=spec, config=config, seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=torch.device(device))


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, overrides: Optional[dict] = None) -> dict:
    """Run cell ``name`` once and return its result line as a dict.

    ``device`` None runs on the card and refuses without one; the tests
    pass ``"cpu"``, which skips that look, with ``overrides``."""
    if device is None:
        require_card(bench.workload(name)["chips"])
        device = "cuda"
    cell = make_cell(bench, name, seed, seconds, trace, device, overrides)
    bench.traffic(cell.spec["kind"]).run(cell)
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found)}")
    return result_line(bench, cell)


def result_line(bench: Bench, cell: Cell) -> dict:
    metrics = {}
    for m in bench.metrics_of(cell.name, cell.trace):
        if cell.trace:
            value = bench.reader(m["name"]).read(cell)
            if value is None:
                cell.note(f"{m['name']}: nothing to read")
                continue
        else:
            value = cell.end_to_end[m["name"]]
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": _device_kind(cell.device), "count": 1,
              "memory_peak_bytes": int(cell.memory_peak_bytes)}
    line = {"correct": bool(cell.checks.get("correct", False)), "attempted": cell.attempted,
            "failed": cell.failed, "metrics": metrics, "device": device}
    if cell.trace and cell.device_trace is not None:
        device["busy_s"] = cell.device_trace.busy_s()
        device["window_s"] = cell.device_trace.window_s()
        line["breakdown"] = cell.device_trace.breakdown()
    line["checks"] = cell.checks.get("lines", {})
    return line


def _device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
