"""bf16 gradient reductions on the PyTorch/CUDA port (counterpart of
examples/by_feature/ddp_comm_hook.py, whose reference registers a DDP
communication hook).

``compile_train_step(grad_reduce_dtype=torch.bfloat16)`` computes the
gradients in bf16 and reduces them across processes in bf16, halving the
bytes on the wire; they are upcast into the f32 masters. The script trains
twice from the same weights, with f32 and with bf16 reductions, and checks
that the losses stay close. On the card by default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import build_model, common_parser, get_dataloaders


def train_once(args, grad_reduce_dtype):
    # A fresh accelerator state (the process and its process group stay).
    AcceleratorState._reset_state()
    GradientState._reset_state()
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision or "bf16", cpu=args.cpu)
    model = build_model(args.seed, accelerator.device)
    train_dl, _ = get_dataloaders(args.batch_size)
    model, optimizer, train_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4), train_dl)
    step = accelerator.compile_train_step(classification_loss(model),
                                          grad_reduce_dtype=grad_reduce_dtype)
    losses = []
    for epoch in range(args.epochs):
        for batch in train_dl:
            losses.append(step(batch)["loss"])
    return accelerator, torch.stack(losses).tolist()


def training_function(args):
    acc, base = train_once(args, None)
    _, narrow = train_once(args, torch.bfloat16)
    acc.print(f"fp32 reductions:  first {base[0]:.4f}  last {base[-1]:.4f}")
    acc.print(f"bf16 reductions:  first {narrow[0]:.4f}  last {narrow[-1]:.4f}")
    drift = max(abs(a - b) for a, b in zip(base, narrow))
    acc.print(f"max per-step loss drift: {drift:.5f} (gradient wire traffic halved)")
    if not drift < 0.1:
        raise RuntimeError("bf16 gradient reductions must track fp32 closely")


def main():
    training_function(common_parser(__doc__).parse_args())


if __name__ == "__main__":
    main()
