"""Profiling on the PyTorch/CUDA port (counterpart of
examples/by_feature/profiler.py).

``accelerator.profile()`` is a ``torch.profiler`` session (the card's
kernels too when the accelerator runs on one) under the schedule of
``ProfileKwargs``: skip 1 step, warm up 1, trace 2; ``prof.step()`` marks
each train step, and the Chrome trace lands in ``--trace_dir``. On the
card by default; ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import ProfileKwargs, set_seed
from example_lib_torch import build_model, common_parser, get_dataloaders


def training_function(args):
    set_seed(args.seed)
    profile_kwargs = ProfileKwargs(
        schedule_option={"wait": 1, "warmup": 1, "active": 2, "repeat": 1},
        output_trace_dir=args.trace_dir)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              kwargs_handlers=[profile_kwargs])
    model = build_model(args.seed, accelerator.device)
    train_dl, _ = get_dataloaders(args.batch_size)
    model, optimizer, train_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4), train_dl)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    with accelerator.profile() as prof:
        losses = []
        for i, batch in enumerate(train_dl):
            losses.append(step(batch)["loss"].item())
            prof.step()
            if i >= 5:
                break
    accelerator.print(f"profiled {len(losses)} steps, trace in {args.trace_dir}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--trace_dir", default="./profile_trace")
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
