"""Gradient accumulation on the PyTorch/CUDA port (counterpart of
examples/by_feature/gradient_accumulation.py).

``compile_train_step(accumulation_steps=k)`` takes a batch whose leaves
have a leading ``[k, micro, ...]`` dim and runs the k microbatches'
forward and backward inside one step, then one update: the accumulation
loop lives in the step, not in the user's code. (``accelerator.accumulate``
is the user's-loop form.) On the card by default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              gradient_accumulation_steps=args.gradient_accumulation_steps)
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    k = args.gradient_accumulation_steps
    step = accelerator.compile_train_step(classification_loss(model), accumulation_steps=k,
                                          max_grad_norm=1.0)

    for epoch in range(args.epochs):
        losses, micro = [], []
        for batch in train_dl:
            micro.append(batch)
            if len(micro) < k:
                continue
            # Stack k microbatches into the [accum, micro, ...] layout the
            # step expects.
            stacked = {key: torch.stack([m[key] for m in micro]) for key in micro[0]}
            losses.append(step(stacked)["loss"])
            micro = []
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                          f"acc {acc:.3f}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=2)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
