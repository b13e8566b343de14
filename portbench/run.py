"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for. One process is one cell and one run: set-up (weights made on the
card from the seed, the program's objects, the warm-up of this cell's
shapes), the measured window of ``--seconds``, with ``--trace 1`` a short
profiled sub-window, then the check against the plain reference. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit). Without a card, or
with a forbidden module loaded, it prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _environment():
    """Build and kernel caches at fixed paths inside the checkout, and no
    library that would load JAX by itself."""
    cache = BENCH_DIR / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    from portbench.core import Bench, Refused, run_cell

    bench = Bench.at(ROOT)
    try:
        line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        print(f"[portbench] refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, check in line["checks"].items():
        print(f"[portbench] check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
