"""A rate sweep of a serving cell, to find its knee: the highest offered
rate the engine sustains without a growing backlog. Card only.

    python3 portbench/sweep.py --workload mistral-serve-chat --rates 2,3,4 --seconds 30 --seed 1

One engine serves the cell's traffic at each rate in turn (the cell's mix,
its ``warmup_s`` ramp, then a window of ``--seconds``); one JSON line a rate:
the offered and served tokens/s, TTFT p50 over the window's first and
second halves (a backlog that grows shows as the second above the first),
TTFT and ITL p95, and the engine's queue depth at the window's end. The
benchmark's runs do not sweep: a cell's rate is fixed in its file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sweep(bench, name: str, rates: list, seconds: float, seed: int, device: str = "cuda",
          overrides=None):
    from portbench.core import make_cell
    from portbench.traffic import open_loop_serve as kind
    from portbench.yardstick import percentile

    cell = make_cell(bench, name, seed, seconds, False, device, overrides)
    model, engine = kind.build(cell)
    try:
        for rate in rates:
            cell.spec = {**cell.spec, "params": {**cell.params, "rate": rate}}
            plan = kind.plan_for(cell)
            window = kind.Window(cell, engine, plan)
            found = window.metrics()
            mid = (window.w0 + window.w1) / 2
            halves = [[(m.times[0] - m.due) * 1e3 for m in window.measured
                       if m.times and (m.due < mid) == first] for first in (True, False)]
            offered = sum(int(plan.outputs[m.index]) for m in window.measured) / seconds
            deadline = time.monotonic() + 180
            for s in window.streams:
                if s.handle is not None:
                    s.handle.wait(max(0.0, deadline - time.monotonic()))
            yield {"rate": rate, "requests": len(window.measured), "failed": window.failed(),
                   "offered_tokens_per_s": offered,
                   "serve_tokens_per_s": found["serve_tokens_per_s"],
                   "ttft_p50_first_half_ms": percentile(halves[0], 50),
                   "ttft_p50_second_half_ms": percentile(halves[1], 50),
                   "ttft_p95_ms": found["ttft_p95_ms"], "itl_p95_ms": found["itl_p95_ms"],
                   "queue_depth_at_close": window.summary["queue_depth"],
                   "queue_wait_ms": window.summary["queue_wait_ms"],
                   "slot_occupancy": window.summary["slot_occupancy"],
                   "generator_lateness_s": window.lateness}
    finally:
        engine.shutdown(drain=False)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="mistral-serve-chat")
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.core import Bench, require_card

    bench = Bench.at(ROOT)
    require_card(bench.workload(args.workload)["chips"])
    for line in sweep(bench, args.workload, [float(r) for r in args.rates.split(",")],
                      args.seconds, args.seed):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
