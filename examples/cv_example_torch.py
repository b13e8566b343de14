"""CV training example on the PyTorch/CUDA port (the counterpart of
examples/cv_example.py).

A ResNet (``accelerate_tpu_torch.models.resnet``, NHWC input, convolutions
in ``torch.channels_last`` on the card) on synthetic images whose class is
the dominant colour channel; the same ``Accelerator`` loop as the NLP
example. It runs on the CUDA card by default; ``--cpu`` runs it on the CPU:

    python examples/cv_example_torch.py            # on the card
    python examples/cv_example_torch.py --cpu      # on the CPU
"""

import argparse

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, NumpyDataLoader
from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig
from accelerate_tpu_torch.utils import set_seed


class SyntheticImages:
    """Images of noise plus 1.0 on the channel that is their label, built
    with numpy from the seed."""

    def __init__(self, n=256, size=32, seed=0):
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, 3, n).astype(np.int32)
        imgs = rng.normal(0.0, 0.3, (n, size, size, 3)).astype(np.float32)
        for i, c in enumerate(self.labels):
            imgs[i, :, :, c] += 1.0
        self.images = imgs

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"pixel_values": self.images[i], "labels": self.labels[i]}


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    gen = torch.Generator(device=accelerator.device).manual_seed(0)
    model = ResNet(ResNetConfig.tiny(num_classes=3), device=accelerator.device, generator=gen)
    model = model.to(memory_format=torch.channels_last)

    train_dl = NumpyDataLoader(SyntheticImages(256), batch_size=args.batch_size, shuffle=True,
                               drop_last=True)
    eval_dl = NumpyDataLoader(SyntheticImages(64, seed=1), batch_size=args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)

    # BatchNorm statistics are not optimizer state: they stay at their
    # initial values (mean 0, var 1) and the forward normalizes with them
    # (train=False), as the JAX example closes over its frozen batch_stats.
    def loss_fn(params, batch):
        logits = torch.func.functional_call(model.module, params, (batch["pixel_values"],),
                                            {"train": False})
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(-1, batch["labels"].long()[:, None]).mean()

    step = accelerator.compile_train_step(loss_fn, max_grad_norm=1.0)
    for epoch in range(args.epochs):
        losses = torch.stack([step(b)["loss"] for b in train_dl])
        correct = total = 0
        with torch.no_grad():
            for batch in eval_dl:
                logits = model(batch["pixel_values"], train=False)
                preds = accelerator.gather_for_metrics(logits.argmax(-1))
                labels = accelerator.gather_for_metrics(batch["labels"])
                correct += int((preds.long() == labels.long()).sum())
                total += len(labels)
        accelerator.print(f"epoch {epoch}: loss {losses.mean().item():.4f} acc "
                          f"{correct / total:.3f}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mixed_precision", default=None)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
