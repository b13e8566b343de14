"""LocalSGD on the PyTorch/CUDA port (counterpart of
examples/by_feature/local_sgd.py).

Each process takes ``local_sgd_steps`` optimizer steps on its own data
without reducing gradients (inside ``no_sync``), then the processes average
their parameters (one all-reduce): less communication a step for a
periodic average. With one process it is the plain step. On the card by
default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator, LocalSGD
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    loss_fn = classification_loss(model)

    with LocalSGD(accelerator, model, optimizer, loss_fn, local_sgd_steps=args.local_sgd_steps,
                  max_grad_norm=1.0) as local_sgd:
        for epoch in range(args.epochs):
            losses = [local_sgd.step(batch)["loss"] for batch in train_dl]
            acc = evaluate(accelerator, model, eval_dl)
            accelerator.print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                              f"acc {acc:.3f}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--local_sgd_steps", type=int, default=4)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
