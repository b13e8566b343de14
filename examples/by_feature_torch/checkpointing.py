"""Checkpoint save and resume on the PyTorch/CUDA port (counterpart of
examples/by_feature/checkpointing.py).

Saves the whole training state (model, optimizer, loader position, RNG and
a registered epoch counter) every epoch with automatic naming and rotation
(``total_limit=2``), and resumes from ``--resume_from_checkpoint`` (a
directory, or "latest": ``load_state`` with no argument). On the card by
default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator, ProjectConfiguration
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders


class EpochTracker:
    epoch = 0

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, sd):
        self.epoch = sd["epoch"]


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision, cpu=args.cpu,
        project_config=ProjectConfiguration(
            project_dir=args.project_dir, automatic_checkpoint_naming=True, total_limit=2))
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    tracker = EpochTracker()
    accelerator.register_for_checkpointing(tracker)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    if args.resume_from_checkpoint:
        accelerator.load_state(
            None if args.resume_from_checkpoint == "latest" else args.resume_from_checkpoint)
        accelerator.print(f"resumed from epoch {tracker.epoch}")

    while tracker.epoch < args.epochs:
        losses = [step(batch)["loss"] for batch in train_dl]
        tracker.epoch += 1
        accelerator.save_state()
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(f"epoch {tracker.epoch}: loss {torch.stack(losses).mean().item():.4f} "
                          f"acc {acc:.3f} (state saved)")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--project_dir", default="./ckpt_example")
    parser.add_argument("--resume_from_checkpoint", default=None,
                        help="'latest' or a checkpoint directory")
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
