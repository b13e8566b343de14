"""Schedule-free AdamW on the PyTorch/CUDA port (counterpart of
examples/by_feature/schedule_free.py, on ``optax.contrib.schedule_free_adamw``).

torch has no schedule-free optimizer, so ``example_lib_torch`` carries a
plain-torch copy of optax's (``ScheduleFreeAdamW``): no learning-rate
decay, a warmup, and evaluation at the averaged parameters, swapped in by
``schedule_free_eval_params`` and back out after. On the card by default;
``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import (
    ScheduleFreeAdamW,
    build_model,
    common_parser,
    evaluate,
    get_dataloaders,
    schedule_free_eval_params,
)


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    tx = ScheduleFreeAdamW(model.parameters(), lr=args.lr, warmup_steps=8)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(model, tx, train_dl, eval_dl)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    for epoch in range(args.epochs):
        losses = [step(batch)["loss"] for batch in train_dl]
        # Evaluate at the schedule-free average, then return to the
        # training point.
        with schedule_free_eval_params(optimizer):
            acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                          f"eval-avg acc {acc:.3f}")


def main():
    training_function(common_parser(__doc__).parse_args())


if __name__ == "__main__":
    main()
