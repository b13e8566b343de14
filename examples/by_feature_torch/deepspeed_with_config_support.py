"""Training from a DeepSpeed ZeRO config on the PyTorch/CUDA port
(counterpart of examples/by_feature/deepspeed_with_config_support.py).

The JSON is translated, not executed: ``DeepSpeedPlugin`` turns stage 2
into sharded optimizer state and gradients over the processes, stage 3 into
sharded parameters too, and an offload device "cpu" into optimizer state
in pinned host memory; no DeepSpeed engine runs. The config's optimizer
and scheduler sections build a torch optimizer and a scheduler that is
prepared with it. On the card by default; ``--cpu`` on the CPU.
"""

import json
import sys
import tempfile
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.bert import classification_loss
from accelerate_tpu_torch.utils import DeepSpeedPlugin, set_seed
from example_lib_torch import build_model, common_parser, evaluate, get_dataloaders

DEFAULT_DS_CONFIG = {
    "train_micro_batch_size_per_gpu": 16,
    "gradient_clipping": 1.0,
    "zero_optimization": {
        "stage": 2,
        "offload_optimizer": {"device": "cpu"},
    },
    # The optimizer and scheduler come from the config (the reference's
    # DummyOptim / DummyScheduler workflow).
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 5}},
    "bf16": {"enabled": True},
}


def training_function(args):
    set_seed(args.seed)
    config_file = args.deepspeed_config_file
    if config_file is None:
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as tmp:
            json.dump(DEFAULT_DS_CONFIG, tmp)
        config_file = tmp.name
    ds_plugin = DeepSpeedPlugin(config_file=config_file)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              deepspeed_plugin=ds_plugin)
    model = build_model(args.seed, accelerator.device)
    train_dl, eval_dl = get_dataloaders(args.batch_size)
    # The config's optimizer if it has one, else the user's own.
    tx = ds_plugin.build_optimizer(model.parameters()) or torch.optim.AdamW(
        model.parameters(), lr=args.lr, weight_decay=1e-4)
    scheduler = ds_plugin.build_scheduler()
    prepared = accelerator.prepare(model, tx, train_dl, eval_dl,
                                   *([scheduler] if scheduler is not None else []))
    model, optimizer, train_dl, eval_dl = prepared[:4]
    scheduler = prepared[4] if scheduler is not None else None
    step = accelerator.compile_train_step(classification_loss(model))

    accelerator.print(
        f"translated ZeRO config: sharding={accelerator.state.fsdp_plugin.sharding_strategy} "
        f"offload={optimizer.offload_to_host}")
    for epoch in range(args.epochs):
        losses = []
        for batch in train_dl:
            losses.append(step(batch)["loss"])
            if scheduler is not None:
                scheduler.step()
        acc = evaluate(accelerator, model, eval_dl)
        lr_note = f" lr {scheduler.get_last_lr()[0]:.2e}" if scheduler is not None else ""
        accelerator.print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                          f"acc {acc:.3f}{lr_note}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--deepspeed_config_file", default=None)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
