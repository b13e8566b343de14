"""Experiment tracking on the PyTorch/CUDA port (counterpart of
examples/by_feature/tracking.py).

``Accelerator(log_with=...)`` names the trackers: "jsonl" (the default: one
JSON object a line under the project directory, no package needed),
"tensorboard", "wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive",
or "all" (every one whose package is installed). ``init_trackers`` starts
them with the run's configuration, ``log`` writes to each (main process
only) and ``end_training`` closes them. On the card by default; ``--cpu``
on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.tracking import LOGGER_TYPE_TO_CLASS
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              log_with=args.log_with, project_dir=args.project_dir)
    accelerator.init_trackers("example_tracking",
                              config={"lr": args.lr, "batch_size": args.batch_size})
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    global_step = 0
    for epoch in range(args.epochs):
        losses = []
        for batch in train_dl:
            losses.append(step(batch)["loss"].item())
            global_step += 1
            accelerator.log({"train_loss": losses[-1]}, step=global_step)
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.log({"eval_accuracy": acc, "epoch": epoch}, step=global_step)
        accelerator.print(f"epoch {epoch}: loss {sum(losses) / len(losses):.4f} acc {acc:.3f}")
    accelerator.end_training()


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--log_with", default="jsonl", choices=["all", *LOGGER_TYPE_TO_CLASS],
                        help='"jsonl", "all", or a tracker name')
    parser.add_argument("--project_dir", default="./tracking_example")
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
