"""Shared building blocks of the PyTorch/CUDA port's example scripts
(``examples/by_feature_torch/``, ``examples/inference_torch/``): the port's
own copy of ``examples/example_lib.py``, which it does not import.

The data is synthetic and download-free, built with numpy from the seed
exactly as the JAX skeleton builds it. The scripts run on the CUDA card by
default and on the CPU with ``--cpu``; without a card and without
``--cpu`` they raise.

Beside the skeleton: :class:`ScheduleFreeAdamW`, a plain-torch copy of
``optax.contrib.schedule_free_adamw`` for ``schedule_free.py`` (torch has
no schedule-free optimizer), and :func:`run_example`, which runs one
script's ``main()`` in this process (the port's tests and ``chip_smoke.py``
run the single-process scripts one after another with it).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch


class SyntheticMRPC:
    """Sentence pairs; equivalent pairs share rare "anchor" tokens (ids
    4-19) in both halves, other tokens are filler (ids 20+), so the
    accuracy the examples print reflects real learning."""

    def __init__(self, n=256, seq_len=64, vocab=1024, seed=0):
        rng = np.random.default_rng(seed)
        half = seq_len // 2
        self.input_ids = rng.integers(20, vocab, (n, seq_len)).astype(np.int32)
        same = rng.integers(0, 2, n).astype(np.int32)
        anchors = rng.integers(4, 20, n)
        for i in np.nonzero(same)[0]:
            for lo in (0, half):  # 3 anchor copies per half
                pos = lo + rng.choice(half, 3, replace=False)
                self.input_ids[i, pos] = anchors[i]
        self.token_type_ids = np.concatenate(
            [np.zeros((n, half), np.int32), np.ones((n, seq_len - half), np.int32)], axis=1)
        self.labels = same

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {
            "input_ids": self.input_ids[i],
            "token_type_ids": self.token_type_ids[i],
            "attention_mask": np.ones_like(self.input_ids[i]),
            "labels": self.labels[i],
        }


def build_model(seed: int = 42, device=None):
    """The examples' tiny BERT classifier on ``device`` (the accelerator's),
    its weights drawn from a generator seeded with ``seed``."""
    from accelerate_tpu_torch.models.bert import BertConfig, BertForSequenceClassification

    gen = torch.Generator(device=device).manual_seed(seed)
    return BertForSequenceClassification(BertConfig.tiny(), device=device, generator=gen)


def get_dataloaders(batch_size: int, n_train: int = 256, n_eval: int = 64):
    from accelerate_tpu_torch import NumpyDataLoader

    train = NumpyDataLoader(SyntheticMRPC(n_train), batch_size=batch_size, shuffle=True,
                            drop_last=True)
    evald = NumpyDataLoader(SyntheticMRPC(n_eval, seed=1), batch_size=batch_size)
    return train, evald


def evaluate(accelerator, model, eval_dl) -> float:
    """Exact accuracy through ``gather_for_metrics`` (the uneven tail is
    dropped, not counted twice)."""
    correct = total = 0
    with torch.no_grad():
        for batch in eval_dl:
            logits = model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"])
            preds = accelerator.gather_for_metrics(logits.argmax(-1))
            labels = accelerator.gather_for_metrics(batch["labels"])
            correct += int((preds.long() == labels.long()).sum())
            total += len(labels)
    return correct / total


def common_parser(description: str):
    import argparse

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--mixed_precision", default=None, choices=[None, "no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    return parser


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """``optax.contrib.schedule_free_adamw`` in plain torch (Defazio et
    al., "The Road Less Scheduled", 2024): AdamW without momentum on the
    base sequence ``z``, the parameters held at ``y = b1 x + (1 - b1) z``,
    where ``x`` averages ``z`` with weights ``max_lr ** weight_lr_power``.
    The learning rate warms up linearly from 0 over ``warmup_steps``; the
    base update reads it at the update count, the averaging weight one
    update ahead, as optax's two counters do. Evaluate at ``x``:
    :func:`schedule_free_eval_params`."""

    def __init__(self, params, lr: float = 0.0025, warmup_steps: int | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, weight_lr_power: float = 2.0):
        super().__init__(params, dict(lr=lr, warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      weight_lr_power=weight_lr_power))

    @staticmethod
    def _rate(group, count: int) -> float:
        warmup = group["warmup_steps"]
        if not warmup:
            return group["lr"]
        return group["lr"] * min(max(count, 0), warmup) / warmup

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            t = group.setdefault("sf_step", 0)
            b1, b2 = group["b1"], group["b2"]
            max_lr = max(group.setdefault("max_lr", 0.0), self._rate(group, t + 1))
            weight = max_lr ** group["weight_lr_power"]
            weight_sum = group.setdefault("weight_sum", 0.0) + weight
            ck = weight / weight_sum if weight_sum > 0 else 0.0
            lr = self._rate(group, t)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["z"] = p.detach().clone()
                    state["v"] = torch.zeros_like(p)
                z, v, g = state["z"], state["v"], p.grad
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                update = g / ((v / (1 - b2 ** (t + 1))).sqrt() + group["eps"])
                update.add_(p, alpha=group["weight_decay"])
                x = (p - (1 - b1) * z) / b1
                z.add_(update, alpha=-lr)
                x.mul_(1 - ck).add_(z, alpha=ck)
                p.copy_(b1 * x + (1 - b1) * z)
            group.update(sf_step=t + 1, max_lr=max_lr, weight_sum=weight_sum)
        return loss


@contextlib.contextmanager
def schedule_free_eval_params(optimizer):
    """Inside, the parameters of ``optimizer`` (a :class:`ScheduleFreeAdamW`,
    or the accelerator's wrapper of one) hold the averaged ``x``
    (``optax.contrib.schedule_free_eval_params``); on exit they return to
    the training point ``y``."""
    optimizer = getattr(optimizer, "optimizer", optimizer)
    saved = []
    with torch.no_grad():
        for group in optimizer.param_groups:
            for p in group["params"]:
                if "z" in optimizer.state.get(p, {}):
                    saved.append((p, p.detach().clone()))
                    p.copy_((p - (1 - group["b1"]) * optimizer.state[p]["z"]) / group["b1"])
    try:
        yield
    finally:
        with torch.no_grad():
            for p, y in saved:
                p.copy_(y)


def run_example(path, argv) -> dict:
    """Run the example script at ``path`` as ``python path *argv`` would, in
    this process: its module loaded by path, ``sys.argv`` set, ``main()``
    called with its output captured. The port's accelerator and gradient
    state are reset first (the process's device and process group stay).
    Returns ``{"script", "argv", "seconds", "stdout", "error"}``, ``error``
    the traceback of a failure, else None."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    path = Path(path)
    AcceleratorState._reset_state()
    GradientState._reset_state()
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    out, error, argv_before = io.StringIO(), None, sys.argv
    t0 = time.perf_counter()
    try:
        sys.argv = [str(path), *map(str, argv)]
        with contextlib.redirect_stdout(out):
            spec.loader.exec_module(module)
            module.main()
    except (Exception, SystemExit):  # a script's failure or exit is its result
        error = traceback.format_exc()
    finally:
        sys.argv = argv_before
    return {"script": path.name, "argv": list(map(str, argv)),
            "seconds": time.perf_counter() - t0, "stdout": out.getvalue(), "error": error}
