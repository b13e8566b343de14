"""The readings the checks' limits are set from, and the controls that
must fail them, at a cell's own size on the card.

    python3 portbench/controls.py train --seeds 1,2,... --control-seeds 1,2,3
    python3 portbench/controls.py serve --seeds 1,2,... --control-seeds 1,2,3 --seconds 10

One line of JSON a seed, then a summary. ``train`` drives the program's
job through its checked updates on each seed (no window) and compares it
with the plain reference: the sound readings. On a control seed it also
drives the program's own fp8 path (``precision: "fp8"``: the accelerator's
``mixed_precision="fp8"`` and the model's fp8 projections, the precision
below the configuration's bf16: the control), the same path from warm
statistics (``control_warm``: one forward and backward of a further batch,
its amaxes committed, before the first update; the cold start flushes the
first update's output gradients in e5m2 at scales of 1), and the reference
on half of each batch (a fault: half the batch left out, the mean over the
rest). A state left unchanged reads 1 by ``grad_gap``'s and
``change_gap``'s measure and needs no run.

``serve`` serves each seed's traffic at the cell's load for a short window
and compares the sampled requests' served tokens with the reference. On a
control seed it also serves the same traffic through the program's int8
path (int8 weights and int8 KV pages: the control), and reads, at each
position of the sound run's prompts and tokens, the gap of the token that
the int8-weight forward puts first. The benchmark's own runs run none of
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _detail(program: dict, reference: dict) -> dict:
    """What a training comparison is made of: each step's loss gap, and the
    leaves with the widest gradient and change gaps."""
    import statistics

    def leaves(key):
        ref = reference[key]
        median = statistics.median(ref.values())
        gaps = {n: abs(program[key][n] - ref[n]) / max(ref[n], median) for n in ref}
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
        return {"median_leaf": statistics.median(gaps.values()), "widest": top}

    steps = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    return {"step_loss_gaps": steps, "grad": leaves("first_grad"), "change": leaves("change")}


def _warm_fp8(job):
    """The fp8 statistics of ``job`` made warm before its first update: a
    forward and backward of a batch the checked updates do not use, its
    amaxes committed, the gradients dropped."""
    import torch

    from accelerate_tpu_torch.ops.quant import commit_fp8_meta
    from portbench.traffic.packed_train import packed_rows

    cell = job.cell
    rows = packed_rows(cell.params, cell.config["vocab_size"], cell.params["rows"], cell.seed + 1)
    job.acc.backward(job.loop.loss_fn, {"input_ids": torch.as_tensor(rows, device=cell.device)})
    commit_fp8_meta(job.model)
    job.optimizer.zero_grad()


def train_readings(bench, name: str, seed: int, control: bool, device: str = "cuda",
                   overrides=None) -> dict:
    """The sound readings of ``seed``, and with ``control`` the control's
    (the program's fp8 path, cold and warm) and the half-batch fault's."""
    from portbench import compare
    from portbench.core import make_cell
    from portbench.traffic import packed_train as kind

    cell = make_cell(bench, name, seed, 0.0, False, device, overrides)
    p = cell.params
    t0 = time.perf_counter()
    job = kind.Job(cell)
    job.free()
    programs = {"sound": job.program}
    if control:
        low = make_cell(bench, name, seed, 0.0, False, device,
                        {"config": (overrides or {}).get("config", {}),
                         "params": {**(overrides or {}).get("params", {}), "precision": "fp8"}})
        fp8 = kind.Job(low)
        fp8.free()
        programs["control"] = fp8.program
        warm = kind.Job(low, before_checked=_warm_fp8)
        warm.free()
        programs["control_warm"] = warm.program
    rows = job.checked_rows()
    t1 = time.perf_counter()
    ref = kind.reference_steps(cell.config, seed, rows, p["rows"], p["optimizer"], cell.device)
    out = {"seed": seed, "program_s": t1 - t0, "reference_s": time.perf_counter() - t1,
           "losses": {k: v["losses"] for k, v in programs.items()},
           "reference_losses": ref["losses"]}
    if control:
        programs["half_batch"] = kind.reference_steps(cell.config, seed, rows, p["rows"],
                                                      p["optimizer"], cell.device,
                                                      keep_rows=p["rows"] // 2)
    out["detail"] = {}
    for key, prog in programs.items():
        out[key] = compare.training_gaps(prog, ref)
        out["detail"][key] = _detail(prog, ref)
    _free(cell.device)
    return out


def serve_readings(bench, name: str, seed: int, seconds: float, control: bool,
                   device: str = "cuda", overrides=None) -> dict:
    """The sound readings of ``seed`` (the served tokens' gaps), and with
    ``control`` two controls': the program's int8-weight path read at each
    position of the same prompts and tokens (``control_forward``), and the
    program's engine serving the same traffic with int8 weights and int8 KV
    pages (``control``)."""
    import torch

    from portbench import compare
    from portbench import weights as W
    from portbench.core import make_cell
    from portbench.reference import dense_decoder
    from portbench.traffic import open_loop_serve as kind

    cell = make_cell(bench, name, seed, seconds, False, device, overrides)
    dtype = getattr(torch, cell.params["dtype"])
    cfg = cell.config
    t0 = time.perf_counter()
    model, prompts, served = kind.serve(cell)
    runs = {"sound": (prompts, served)}
    seqs, picks = kind.reference_sequences(prompts, served, cell.device)
    lower = None
    if control:
        from accelerate_tpu_torch.adapters import quantize_base_weights

        quantized = quantize_base_weights(model)
        with torch.inference_mode():
            lower = [quantized(s[None])[0, p].float().argmax(-1).cpu()
                     for s, p in zip(seqs, picks)]
        del quantized
    del model
    _free(cell.device)
    if control:
        engine = {**cell.params["engine"], "weights_dtype": "int8", "kv_dtype": "int8"}
        low = make_cell(bench, name, seed, seconds, False, device,
                        {"config": (overrides or {}).get("config", {}),
                         "params": {**(overrides or {}).get("params", {}), "engine": engine}})
        model, low_prompts, low_served = kind.serve(low)
        runs["control"] = (low_prompts, low_served)
        del model
        _free(cell.device)
    t1 = time.perf_counter()
    out = {"seed": seed, "program_s": t1 - t0, "requests": len(prompts),
           "served_tokens": sum(len(t) for t in served),
           "ttft_p95_ms": cell.end_to_end.get("ttft_p95_ms")}
    for key, (ps, ts) in runs.items():
        s_, p_ = kind.reference_sequences(ps, ts, cell.device)
        logits = dense_decoder.logits_at(
            cfg, W.make_ends(cfg, seed, cell.device, dtype),
            lambda i: W.make_layer(cfg, seed, i, cell.device, dtype), s_, p_)
        out[key] = compare.logit_gaps(logits, [torch.as_tensor(t) for t in ts])
        if key == "sound" and lower is not None:
            out["control_forward"] = compare.logit_gaps(logits, lower)
        del logits
        _free(cell.device)
    out["reference_s"] = time.perf_counter() - t1
    return out


def summary(lines: list) -> dict:
    """Per number: the largest sound reading and the smallest control and
    fault readings."""
    out = {}
    for key, pick in (("sound", max), ("control", min), ("control_warm", min),
                      ("control_forward", min), ("half_batch", min)):
        rows = [r[key] for r in lines if key in r]
        if rows:
            out[key] = {k: pick(r[k] for r in rows) for k in rows[0]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kind", choices=("train", "serve"))
    parser.add_argument("--workload")
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.core import Bench, require_card

    bench = Bench.at(ROOT)
    name = args.workload or {"train": "mixtral-train-packed4k",
                             "serve": "mistral-serve-chat"}[args.kind]
    require_card(bench.workload(name)["chips"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.kind == "train":
            line = train_readings(bench, name, seed, seed in controls)
        else:
            line = serve_readings(bench, name, seed, args.seconds, seed in controls)
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
