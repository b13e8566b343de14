"""FSDP with memory tracking on the PyTorch/CUDA port (counterpart of
examples/by_feature/fsdp_with_peak_mem_tracking.py).

``FullyShardedDataParallelPlugin`` shards the parameters, gradients and
optimizer state over the processes; ``--cpu_offload`` keeps the optimizer
state in pinned host memory between steps and ``--activation_checkpointing``
recomputes each layer in the backward. Each epoch prints the card's
allocated memory before and after (0 on the CPU). On the card by default;
``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import FullyShardedDataParallelPlugin, set_seed
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders


def device_memory_mb(device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / 2**20


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision, cpu=args.cpu,
        fsdp_plugin=FullyShardedDataParallelPlugin(
            min_weight_size_to_shard=1, cpu_offload=args.cpu_offload,
            activation_checkpointing=args.activation_checkpointing))
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        train_dl, eval_dl)
    step = accelerator.compile_train_step(classification_loss(model), max_grad_norm=1.0)

    for epoch in range(args.epochs):
        before = device_memory_mb(accelerator.device)
        losses = [step(batch)["loss"] for batch in train_dl]
        after = device_memory_mb(accelerator.device)
        acc = evaluate(accelerator, model, eval_dl)
        accelerator.print(
            f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} acc {acc:.3f} "
            f"device memory {before:.1f} -> {after:.1f} MiB "
            f"(offload={'on' if optimizer.offload_to_host else 'off'})")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--cpu_offload", action="store_true")
    parser.add_argument("--activation_checkpointing", action="store_true")
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
