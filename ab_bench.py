#!/usr/bin/env python3
"""Train-step times of several checkouts of this repository on one card, in turns.

    python3 ab_bench.py PARENT . . PARENT [--iters 10]
    python3 ab_bench.py PARENT . . PARENT --kernels

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

``--kernels`` times each directory's flash kernels instead, at the bf16
causal shapes of ``KERNEL_SHAPES``: the wgmma forward and dK/dV
(``flash_cuda._fwd_wgmma``, ``_BackwardLaunch.dkdv_wgmma``) and dQ through
its route dispatcher (``_BackwardLaunch.dq``), whose route the line names
(``<shape> dq route``: "wgmma" or "mma.sync", as that checkout's
``_wgmma_route`` chose it). Each time is the best of 3 CUDA-event windows
of 50 launches, after 3 warm-up launches. One JSON line per directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CONFIGS = {"remat=False": {}, "nothing": {"remat": True, "remat_policy": "nothing"},
           "dots": {"remat": True, "remat_policy": "dots"}}

# (B, S, H, G, D) of the kernel timings: the tier-1 training shape, the
# Llama-3-8B main path, OPT-30B's and GPT-2 XL's forwards, and the Phi-2,
# GPT-NeoX-20B and GPT-J-6B backward shapes (chip_smoke.py phase 14).
KERNEL_SHAPES = {"train": (8, 1024, 16, 8, 128), "main": (4, 2048, 32, 8, 128),
                 "opt": (4, 2048, 56, 56, 128), "gpt2": (8, 1024, 25, 25, 64),
                 "phi": (8, 1024, 32, 32, 80), "neox": (8, 1024, 64, 64, 96),
                 "gptj": (8, 1024, 16, 16, 256)}

KERNEL_CHILD = r"""
import json, subprocess, sys
sys.path.insert(0, ".")
import torch
from accelerate_tpu_torch.ops import flash_cuda as fc
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
res = {}
for name, (B, S, H, G, D) in json.loads(sys.argv[1]).items():
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, G, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, G, D), generator=gen, device="cuda").bfloat16()
    args = (q, k, v, True, None, None, None, None)
    out, lse = fc._fwd_wgmma(*args)
    launch = fc._BackwardLaunch(q, k, v, out, lse, torch.randn_like(q), True, None, None, None,
                                None)
    res[f"{name} dq route"] = "wgmma" if launch.dq_on_wgmma else "mma.sync"
    for kind, fn in (("fwd", lambda: fc._fwd_wgmma(*args)), ("dkdv", launch.dkdv_wgmma),
                     ("dq", launch.dq)):
        for _ in range(3):
            fn()
        best = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(50):
                fn()
            b.record()
            torch.cuda.synchronize()
            best.append(a.elapsed_time(b) / 50)
        res[f"{name} {kind} ms"] = min(best)
print(json.dumps({**res, "card": card}), flush=True)
"""

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
    parser.add_argument("--kernels", action="store_true",
                        help="time the flash forward, dK/dV and dQ kernels instead")
    args = parser.parse_args()
    child = ([KERNEL_CHILD, json.dumps(KERNEL_SHAPES)] if args.kernels
             else [CHILD, json.dumps(CONFIGS), str(args.iters)])
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", *child], cwd=tree, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            sys.exit(f"the bench failed in {tree} (exit {proc.returncode})")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"run": i, "tree": tree, **json.loads(line)}), flush=True)


if __name__ == "__main__":
    main()
