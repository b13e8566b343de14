#!/usr/bin/env python3
"""Train-step times of several checkouts of this repository on one card, in turns.

    python3 ab_bench.py PARENT . . PARENT [--iters 10]

For each directory, in the order given, a fresh process imports that
directory's ``accelerate_tpu_torch`` and runs its ``bench.run_bench`` (the
tier-1 Llama, 8 x 1024 tokens, bf16 over f32 masters, AdamW, clip 1.0)
once per configuration: no remat, ``remat_policy="nothing"``, and
``remat_policy="dots"`` (in a checkout where "dots" was not yet its own
policy, whatever that checkout ran for it). Give the parent commit as a
directory of its files (``git archive``) and list it first and last, so
that drift of the card shows. Prints one JSON line per (directory,
configuration) with the step ms, the peak GiB, the first loss and the
card's name and power limit; exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CONFIGS = {"remat=False": {}, "nothing": {"remat": True, "remat_policy": "nothing"},
           "dots": {"remat": True, "remat_policy": "dots"}}

CHILD = r"""
import gc, json, subprocess, sys
sys.path.insert(0, ".")
import torch
from accelerate_tpu_torch.bench import run_bench
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
for label, overrides in json.loads(sys.argv[1]).items():
    extra = run_bench(iters=int(sys.argv[2]), **overrides)["extra"]
    print(json.dumps({"config": label, "step_ms": extra["step_ms"],
                      "peak_gib": extra["peak_memory_gib"], "first_loss": extra["losses"][0],
                      "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkouts of the repository, in run order")
    parser.add_argument("--iters", type=int, default=10, help="timed steps per configuration")
    args = parser.parse_args()
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(CONFIGS), str(args.iters)],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            sys.exit(f"the bench failed in {tree} (exit {proc.returncode})")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"run": i, "tree": tree, **json.loads(line)}), flush=True)


if __name__ == "__main__":
    main()
