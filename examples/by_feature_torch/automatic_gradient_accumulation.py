"""Automatic gradient accumulation on the PyTorch/CUDA port (counterpart of
examples/by_feature/automatic_gradient_accumulation.py).

``find_executable_batch_size`` retries the loop with a halved batch after
``torch.OutOfMemoryError``; the accumulation count grows as the batch
shrinks, so the EFFECTIVE batch size, and so the optimizer's updates, stay
the same whatever fits on the card. On the card by default; ``--cpu`` on
the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from accelerate_tpu_torch.utils.memory import find_executable_batch_size
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    observed_batch_size = args.batch_size  # the effective target

    @find_executable_batch_size(starting_batch_size=observed_batch_size)
    def inner_training_loop(batch_size):
        accum = max(observed_batch_size // batch_size, 1)
        accelerator.print(f"batch_size={batch_size} x accumulation={accum} "
                          f"(effective {batch_size * accum})")
        accelerator.free_memory()
        model = build_model(args.seed, accelerator.device)
        train_dl, eval_dl = get_dataloaders(batch_size)
        model, optimizer, train_dl, eval_dl = accelerator.prepare(
            model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
            train_dl, eval_dl)
        step = accelerator.compile_train_step(classification_loss(model),
                                              accumulation_steps=accum, max_grad_norm=1.0)
        for epoch in range(args.epochs):
            losses, micro = [], []
            for batch in train_dl:
                if accum == 1:
                    losses.append(step(batch)["loss"])
                    continue
                micro.append(batch)
                if len(micro) < accum:
                    continue
                stacked = {key: torch.stack([m[key] for m in micro]) for key in micro[0]}
                losses.append(step(stacked)["loss"])
                micro = []
            acc = evaluate(accelerator, model, eval_dl)
            accelerator.print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                              f"acc {acc:.3f}")

    inner_training_loop()


def main():
    training_function(common_parser(__doc__).parse_args())


if __name__ == "__main__":
    main()
