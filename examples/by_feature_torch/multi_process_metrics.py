"""Exact metrics across processes on the PyTorch/CUDA port (counterpart of
examples/by_feature/multi_process_metrics.py).

The last eval batch of each process is padded so that every process takes
part in each gather; ``gather_for_metrics`` drops exactly the duplicated
tail samples, so a metric's denominator is exact. Several processes:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \\
        --num_processes 2 --use_cpu_emulation examples/by_feature_torch/multi_process_metrics.py

On the card by default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import build_model, common_parser, get_dataloaders


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    model = build_model(args.seed, accelerator.device)
    # 100 eval samples: not a multiple of the batch, so the tail's duplicates
    # are what gather_for_metrics must drop.
    train_dl, eval_dl = get_dataloaders(args.batch_size, n_eval=100)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    for epoch in range(args.epochs):
        for batch in train_dl:
            step(batch)
        all_preds, all_labels = [], []
        with torch.no_grad():
            for batch in eval_dl:
                logits = model(batch["input_ids"], batch["attention_mask"],
                               batch["token_type_ids"])
                all_preds.append(accelerator.gather_for_metrics(logits.argmax(-1)).long())
                all_labels.append(accelerator.gather_for_metrics(batch["labels"]).long())
        preds, labels = torch.cat(all_preds), torch.cat(all_labels)
        if len(labels) != 100:
            raise RuntimeError(f"metric denominator must be exact, got {len(labels)}")
        accelerator.print(f"epoch {epoch}: accuracy {(preds == labels).float().mean().item():.3f} "
                          f"over exactly {len(labels)} samples")


def main():
    training_function(common_parser(__doc__).parse_args())


if __name__ == "__main__":
    main()
