"""Canonical training-loop example on the PyTorch/CUDA port (the counterpart
of examples/nlp_example.py).

A BERT-style classifier (``accelerate_tpu_torch.models.bert``) trained with
the port's ``Accelerator``: ``prepare``, ``compile_train_step``, a
warmup-then-cosine learning-rate schedule and ``gather_for_metrics``. It
runs on the CUDA card by default; ``--cpu`` runs it on the CPU:

    python examples/nlp_example_torch.py            # on the card
    python examples/nlp_example_torch.py --cpu      # on the CPU

Data is synthetic (paraphrase-detection-shaped, no downloads), built with
numpy from the seed by the examples' skeleton (``example_lib_torch``): pairs
of token sequences whose label is whether they share rare anchor tokens,
enough to watch the loss fall and ``gather_for_metrics`` produce exact eval
counts with an uneven final batch.
"""

import argparse
import math

import torch

from accelerate_tpu_torch import Accelerator, NumpyDataLoader
from accelerate_tpu_torch.models.bert import (
    BertConfig,
    BertForSequenceClassification,
    classification_loss,
)
from accelerate_tpu_torch.scheduler import LRScheduler
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import SyntheticMRPC


def warmup_cosine_decay(init_value, peak_value, warmup_steps, decay_steps, end_value=0.0):
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine down to
    ``end_value`` at ``decay_steps`` (warmup included)."""

    def schedule(count):
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        frac = min(count - warmup_steps, decay_steps - warmup_steps) / (decay_steps - warmup_steps)
        return end_value + (peak_value - end_value) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    # No dropout: at this tiny scale and ~300 optimizer steps it halves the
    # learning signal; real workloads turn it back on.
    cfg = BertConfig.tiny(hidden_dropout_prob=0.0)
    gen = torch.Generator(device=accelerator.device).manual_seed(args.seed)
    model = BertForSequenceClassification(cfg, device=accelerator.device, generator=gen)

    train_dl = NumpyDataLoader(SyntheticMRPC(1024), batch_size=args.batch_size, shuffle=True,
                               drop_last=True)
    eval_dl = NumpyDataLoader(SyntheticMRPC(100, seed=1), batch_size=args.batch_size)

    # optax.adamw(schedule) applies schedule(count) at the count-th update:
    # the optimizer starts at schedule(0), and the scheduler steps after
    # each update.
    schedule = warmup_cosine_decay(0.0, args.lr, 20, args.epochs * len(train_dl))
    optimizer = torch.optim.AdamW(model.parameters(), lr=schedule(0), weight_decay=1e-4)
    model, optimizer, train_dl, eval_dl, scheduler = accelerator.prepare(
        model, optimizer, train_dl, eval_dl, LRScheduler(schedule))
    # No grad clipping, as in the reference's nlp_example.
    step = accelerator.compile_train_step(classification_loss(model))

    for epoch in range(args.epochs):
        losses = []
        for batch in train_dl:
            losses.append(step(batch)["loss"])
            scheduler.step()
        # eval: exact sample counts through gather_for_metrics despite the uneven last batch
        correct = total = 0
        with torch.no_grad():
            for batch in eval_dl:
                logits = model(batch["input_ids"], batch["attention_mask"],
                               batch["token_type_ids"])
                preds = accelerator.gather_for_metrics(logits.argmax(-1))
                labels = accelerator.gather_for_metrics(batch["labels"])
                correct += int((preds.long() == labels.long()).sum())
                total += len(labels)
        train_loss = torch.stack(losses).mean().item()
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f} eval_acc "
                          f"{correct / total:.3f} ({total} samples)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mixed_precision", default=None, choices=[None, "no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
