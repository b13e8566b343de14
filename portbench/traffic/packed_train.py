"""Traffic kind ``packed_train``: a causal-LM training job on packed rows,
through the loop Accelerate users write.

Documents of seeded lognormal lengths (clipped), each followed by a
separator token, are laid end to end and cut into rows of ``seq_len``
tokens, with no document mask (Megatron-LM's default packing). Each update
takes ``rows`` rows::

    accelerator = Accelerator(mixed_precision=...)
    model, optimizer, loader, scheduler = accelerator.prepare(
        model, AdamW(...), loader, LambdaLR(...))
    for batch in loader:
        loss = accelerator.backward(loss_fn, batch)
        accelerator.clip_grad_norm_(max_norm=...)
        optimizer.step()
        scheduler.step()
        optimizer.zero_grad()

Set-up makes the weights on the device from the seed, builds that one
loop and drives it through its first ``checked_steps`` updates (every
shape of the window warms up there), recording their losses, the first
gradient as the optimizer got it (from AdamW's first moment after one
update) and each parameter's change. The window then runs the same loop on
further rows for ``--seconds``, and records the kept (token, expert) pairs
of each update. A traced run profiles ``traced_steps`` more updates after
the window. Once the program's state is freed, the plain reference follows
the checked updates from the same weights and rows
(:mod:`portbench.reference.mixtral_train`).

Parameters (``params`` of the cell): ``rows``, ``seq_len``,
``doc_median``, ``doc_sigma``, ``doc_min``, ``doc_max``, ``separator``,
``precision`` (the accelerator's ``mixed_precision``; ``"fp8"`` also turns
on the model's fp8 projections), ``optimizer`` (``lr``, the peak rate,
reached linearly over ``warmup_steps`` updates: update ``t`` from 1 takes
``lr * min(1, t / warmup_steps)``; ``betas``, ``eps``, ``weight_decay``,
``max_grad_norm``), ``checked_steps``, ``traced_steps``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import compare, port
from portbench import trace as T
from portbench.core import process_seconds
from portbench.reference import mixtral_train
from portbench.yardstick import lognormal_lengths


def packed_rows(p: dict, vocab: int, count: int, seed: int) -> np.ndarray:
    """``count`` rows of ``seq_len`` tokens: seeded documents (token ids
    from 3, below the vocabulary) of lognormal lengths, each followed by
    the separator, end to end."""
    rng = np.random.default_rng([int(seed) % 2**64, 1])
    need = count * p["seq_len"]
    parts, total = [], 0
    while total < need:
        lengths = lognormal_lengths(256, p["doc_median"], p["doc_sigma"], p["doc_min"],
                                    p["doc_max"], rng)
        for n in lengths:
            doc = rng.integers(3, vocab, size=int(n) + 1, dtype=np.int64)
            doc[-1] = p["separator"]
            parts.append(doc)
            total += doc.size
    return np.concatenate(parts)[:need].reshape(count, p["seq_len"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warmup_factor(warmup_steps: int):
    """The share of the peak rate that update ``k + 1`` takes, as a
    ``LambdaLR`` factor of ``k``, the updates already made."""
    return lambda k: min(1.0, (k + 1) / warmup_steps)


class _Loop:
    """The user's training loop over a prepared loader, one update a call,
    with CUDA events around clip, step, the schedule's step and zero_grad."""

    def __init__(self, accelerator, model, optimizer, scheduler, loader, loss_fn, max_norm,
                 on_card):
        self.acc, self.model, self.opt, self.scheduler = accelerator, model, optimizer, scheduler
        self.loader, self.loss_fn, self.max_norm = loader, loss_fn, max_norm
        self.batches = iter(loader)
        self.on_card = on_card
        self.events = []

    def step(self):
        try:
            batch = next(self.batches)
        except StopIteration:
            self.batches = iter(self.loader)
            batch = next(self.batches)
        loss = self.acc.backward(self.loss_fn, batch)
        mark = torch.cuda.Event(enable_timing=True) if self.on_card else None
        if mark is not None:
            mark.record()
        self.acc.clip_grad_norm_(max_norm=self.max_norm)
        self.opt.step()
        self.scheduler.step()
        self.opt.zero_grad()
        if mark is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            self.events.append((mark, done))
        return loss


def _first_grads(model, optimizer, cfg, beta1) -> dict:
    """Each parameter's gradient norm as AdamW got it in its first update:
    its first moment over ``1 - beta1``, under the benchmark's names."""
    state = optimizer.optimizer.state
    params = dict(model.module.named_parameters())
    out = {}
    for name in _bench_names(cfg):
        moment = state.get(params[port.program_name(cfg, name)], {}).get("exp_avg")
        out[name] = (0.0 if moment is None  # the optimizer got nothing
                     else float(torch.linalg.vector_norm(moment.float())) / (1 - beta1))
    return out


def _changes(model, cfg, seed, device) -> dict:
    """Each parameter's change from the seed's weights, made anew."""
    params = dict(model.module.named_parameters())
    out = {}
    with torch.no_grad():
        for group in port.groups(cfg, seed, device, torch.float32):
            for name, start in group.items():
                now = params[port.program_name(cfg, name)]
                out[name] = float(torch.linalg.vector_norm(now.float() - start))
            del group
    return out


def _bench_names(cfg) -> list:
    names = ["embed", "final_norm", "head"]
    for i in range(cfg["num_hidden_layers"]):
        names += [f"L{i}.attn_norm", f"L{i}.mlp_norm"]
        names += [f"L{i}.{s}" for s, _, _ in port.W.layer_shapes(cfg)]
    return names


def _kept_pairs(model) -> torch.Tensor:
    """Kept (token, expert) pairs of the last forward, over the layers: a
    device scalar, read without waiting for the device."""
    return sum(c["expert_load"].sum() for c in model.module.routing_counters())


class Job:
    """The program's training job of one run, driven through its checked
    updates: ``program`` holds their readings (``losses``, ``first_grad``,
    ``change``). ``before_checked(job)``, if given, runs once the job is
    prepared, before its first update."""

    def __init__(self, cell, before_checked=None):
        from accelerate_tpu_torch import Accelerator, NumpyDataLoader
        from accelerate_tpu_torch.models.mixtral import mixtral_lm_loss
        from accelerate_tpu_torch.state import AcceleratorState, GradientState

        p, cfg, device = cell.params, cell.config, cell.device
        self.cell, self.on_card = cell, device.type == "cuda"
        hyper = p["optimizer"]
        # Enough rows that the window never wraps: a generous bound of updates.
        updates = p["checked_steps"] + p["traced_steps"] + int(math.ceil(cell.seconds * 8)) + 8
        self.rows = packed_rows(p, cfg["vocab_size"], p["rows"] * updates, cell.seed)

        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        self.acc = Accelerator(mixed_precision=p["precision"], cpu=not self.on_card)
        extra = {"use_fp8": True} if p["precision"] == "fp8" else {}  # its fp8 projections
        model = port.build_model(cfg, cell.seed, device, torch.float32, **extra)
        optimizer = torch.optim.AdamW(model.parameters(), lr=hyper["lr"],
                                      betas=tuple(hyper["betas"]), eps=hyper["eps"],
                                      weight_decay=hyper["weight_decay"], fused=self.on_card)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                      warmup_factor(hyper["warmup_steps"]))
        loader = NumpyDataLoader([{"input_ids": r} for r in self.rows], batch_size=p["rows"])
        self.model, self.optimizer, loader, scheduler = self.acc.prepare(
            model, optimizer, loader, scheduler)
        self.loop = _Loop(self.acc, self.model, self.optimizer, scheduler, loader,
                          mixtral_lm_loss(self.model), hyper["max_grad_norm"], self.on_card)
        if before_checked is not None:
            before_checked(self)

        self.program = {"losses": []}
        for t in range(p["checked_steps"]):
            self.program["losses"].append(float(self.loop.step()))
            if t == 0:
                self.program["first_grad"] = _first_grads(self.model, self.optimizer, cfg,
                                                          hyper["betas"][0])
        self.program["change"] = _changes(self.model, cfg, cell.seed, device)

    def checked_rows(self) -> np.ndarray:
        p = self.cell.params
        return self.rows[:p["rows"] * p["checked_steps"]]

    def free(self):
        """Drop the program's state and release its device memory."""
        from accelerate_tpu_torch.state import AcceleratorState, GradientState

        self.loop = self.model = self.optimizer = None
        self.acc.free_memory()
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


def run(cell):
    p, cfg, device = cell.params, cell.config, cell.device
    B, S = p["rows"], p["seq_len"]
    job = Job(cell)
    loop, acc = job.loop, job.acc
    loop.events.clear()
    acc.pipeline_stats.reset()
    _sync(device)
    setup_s = process_seconds()

    t0 = time.perf_counter()
    losses, kept = [], []
    while time.perf_counter() - t0 < cell.seconds:
        losses.append(loop.step())
        kept.append(_kept_pairs(job.model))
    _sync(device)
    elapsed = time.perf_counter() - t0
    steps = len(losses)
    pairs = cfg["num_experts_per_tok"] * B * S * cfg["num_hidden_layers"]
    cell.attempted = steps
    cell.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    cell.end_to_end = {"train_tokens_per_s": steps * B * S / elapsed, "setup_s": setup_s}
    cell.counters = {
        "steps": steps, "window_s": elapsed, "tokens_per_step": B * S,
        "data_wait_ms": acc.input_pipeline_metrics()["data_wait_ms"],
        "optimizer_ms": (sum(a.elapsed_time(b) for a, b in loop.events) / len(loop.events)
                         if loop.events else None),
        "train_tokens_per_s": cell.end_to_end["train_tokens_per_s"],
    }
    cell.note(f"window: {steps} updates in {elapsed:.3f} s; set-up {setup_s:.3f} s; "
              f"kept share of pairs by quarter {_quarters(kept, pairs)}")

    if cell.trace:
        traced = []
        prof = T.profiler()
        with prof:
            for _ in range(p["traced_steps"]):
                loop.step()
                traced.append(_kept_pairs(job.model))
            _sync(device)
        cell.device_trace = T.read(prof)
        cell.counters.update(traced_steps=p["traced_steps"],
                             kept_pairs=int(sum(float(k) for k in traced)))
        cell.note(f"traced updates: kept share of pairs "
                  f"{cell.counters['kept_pairs'] / (pairs * p['traced_steps']):.4f}")
    if job.on_card:
        cell.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del loop, losses
    job.free()

    t_ref = time.perf_counter()
    reference = reference_steps(cfg, cell.seed, job.checked_rows(), B, p["optimizer"], device)
    numbers = compare.training_gaps(job.program, reference)
    limits = cell.spec["limits"]
    cell.checks = {"correct": compare.verdict(numbers, limits),
                   "lines": compare.check_lines(numbers, limits)}
    cell.note(f"reference: {time.perf_counter() - t_ref:.3f} s; losses {job.program['losses']}, "
              f"reference {reference['losses']} (loss_gap {numbers['loss_gap']}, not compared)")


def _quarters(kept: list, pairs: int) -> list:
    """The mean kept share of the ``pairs`` (token, expert) pairs an
    update routes, in each quarter of the window's updates."""
    if not kept:
        return []
    shares = torch.stack(kept).double().cpu().numpy() / pairs
    return [round(float(q.mean()), 4) for q in np.array_split(shares, 4) if q.size]


def reference_steps(cfg, seed, rows, B, hyper, device, keep_rows=None) -> dict:
    """The plain reference's first updates on ``rows`` (``B`` a batch) from
    the seed's weights; ``keep_rows`` keeps only the first rows of each
    batch (a fault of the controls)."""
    w = {}
    for group in port.groups(cfg, seed, device, torch.float32):
        w.update(group)
    ids = torch.as_tensor(rows, device=device)
    batches = [ids[i:i + B][:keep_rows] for i in range(0, len(ids), B)]
    out = mixtral_train.train(w, cfg, batches, hyper,
                              lambda: port.groups(cfg, seed, device, torch.float32))
    del w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
