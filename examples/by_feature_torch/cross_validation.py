"""k-fold cross-validation on the PyTorch/CUDA port (counterpart of
examples/by_feature/cross_validation.py).

One model a fold, each trained on the other folds; their test logits are
averaged into an ensemble. ``free_memory`` drops a fold's prepared
objects before the next. On the card by default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, NumpyDataLoader
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import SyntheticMRPC, build_model, common_parser


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    data = SyntheticMRPC(256)
    test = SyntheticMRPC(64, seed=9)
    folds = np.array_split(np.arange(len(data)), args.num_folds)

    test_logits = []
    for fold_id in range(args.num_folds):
        train_idx = np.concatenate([f for i, f in enumerate(folds) if i != fold_id])
        train_dl = NumpyDataLoader([data[int(i)] for i in train_idx], batch_size=args.batch_size,
                                   shuffle=True, drop_last=True)
        test_dl = NumpyDataLoader([test[i] for i in range(len(test))], batch_size=args.batch_size)
        model = build_model(args.seed + fold_id, accelerator.device)
        model, optimizer, train_dl, test_dl = accelerator.prepare(
            model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
            train_dl, test_dl)
        step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)
        for epoch in range(args.epochs):
            for batch in train_dl:
                step(batch)
        fold_logits, labels = [], []
        with torch.no_grad():
            for batch in test_dl:
                logits = model(batch["input_ids"], batch["attention_mask"],
                               batch["token_type_ids"])
                fold_logits.append(accelerator.gather_for_metrics(logits).float().cpu())
                labels.append(accelerator.gather_for_metrics(batch["labels"]).cpu())
        test_logits.append(torch.cat(fold_logits))
        test_labels = torch.cat(labels)
        accelerator.free_memory()
        accelerator.print(f"fold {fold_id} done")

    ensemble = torch.stack(test_logits).mean(0)
    acc = (ensemble.argmax(-1) == test_labels.long()).float().mean().item()
    accelerator.print(f"ensemble accuracy over {args.num_folds} folds: {acc:.3f}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--num_folds", type=int, default=2)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
