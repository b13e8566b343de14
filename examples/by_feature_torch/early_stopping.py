"""Early stopping across processes on the PyTorch/CUDA port (counterpart of
examples/by_feature/early_stopping.py).

The stop decision must be global: a process that left the loop alone would
leave the others waiting in a collective. ``set_trigger`` records a local
decision and ``check_trigger`` reduces the flags over every process (one
all-reduce), so all of them stop on the same epoch. On the card by
default; ``--cpu`` on the CPU.
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
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    best, patience_left = float("inf"), args.patience
    for epoch in range(args.epochs):
        epoch_loss = torch.stack([step(batch)["loss"] for batch in train_dl]).mean().item()
        if epoch_loss < best - args.min_delta:
            best, patience_left = epoch_loss, args.patience
        else:
            patience_left -= 1
            if patience_left <= 0:
                accelerator.set_trigger()  # local decision...
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {epoch}: loss {epoch_loss:.4f} acc {acc:.3f}")
        if accelerator.check_trigger():  # ...reduced globally
            accelerator.print(f"early stop at epoch {epoch} (no improvement)")
            break


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--patience", type=int, default=1)
    parser.add_argument("--min_delta", type=float, default=0.0)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
