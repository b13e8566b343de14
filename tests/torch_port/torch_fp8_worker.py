"""The body of the port's fp8 world tests, run in each process of a gloo
world by ``accelerate-tpu-torch launch --use_cpu_emulation``:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes 2 torch_fp8_worker.py OUT_DIR

For each layout of ``benchmarks/fp8.py`` in turn, ``dp``, ``fsdp``
(FULL_SHARD, every leaf sharded) and ``zero2`` (a DeepSpeed ZeRO-2 config,
translated onto FSDP), in one process group: the stacked tiny Llama with
fp8 projections starts from ``OUT_DIR/fp8_in.npz`` (weights and
statistics) and takes fused AdamW steps on this process's rows of each
global batch. Each commit's pending amaxes are kept as this process
recorded them (before the world's max) and the statistics after it. Then
the process asks for a tp plugin of 2 and a pp plugin of 2, and keeps
each refusal's message. Results go to ``OUT_DIR/<layout>_<rank>.npz``
(the refusals beside ``dp``'s).
"""

import sys
from pathlib import Path

import numpy as np
import torch

from accelerate_tpu_torch import (
    Accelerator,
    DeepSpeedPlugin,
    FullyShardedDataParallelPlugin,
    LlamaConfig,
    PipelineParallelPlugin,
    PipelinedLlamaForCausalLM,
    TensorParallelPlugin,
    fused_causal_lm_loss,
)
from accelerate_tpu_torch.ops import quant
from accelerate_tpu_torch.state import AcceleratorState, GradientState

#: The tiny Llama of ``benchmarks/fp8.py``.
CONFIG = dict(hidden_size=128, intermediate_size=256, use_flash_attention=False, use_fp8=True)
PLUGINS = {
    "dp": {},
    "fsdp": dict(fsdp_plugin=FullyShardedDataParallelPlugin(min_weight_size_to_shard=1)),
    "zero2": dict(deepspeed_plugin=DeepSpeedPlugin(zero_stage=2)),
}


def stats_of(module) -> dict:
    return {name: t.detach().clone().numpy() for name, t in module.state_dict().items()
            if name.rsplit(".", 1)[-1] in quant.FP8_META_NAMES}


def build(inputs, **plugins):
    acc = Accelerator(mixed_precision=str(inputs["precision"]), **plugins)
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(**CONFIG), device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    return acc, model


def run(layout: str, out: Path, inputs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc, model = build(inputs, **PLUGINS[layout])
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    local, committed = [], []
    real_commit = quant.commit_fp8_meta

    def commit(m):
        local.append(np.concatenate([mod.amax_pending.clone().reshape(-1).numpy()
                                     for mod in quant.fp8_modules(m)]))
        real_commit(m)
        committed.append(np.concatenate([mod.input_amax_history[..., 0].reshape(-1).numpy()
                                         for mod in quant.fp8_modules(m)]))

    quant.commit_fp8_meta = commit
    rows = inputs["input_ids"].shape[1] // acc.num_processes
    mine = slice(rows * acc.process_index, rows * (acc.process_index + 1))
    losses = []
    try:
        for s in range(inputs["input_ids"].shape[0]):
            metrics = step({"input_ids": torch.from_numpy(inputs["input_ids"][s, mine]).long()})
            losses.append(metrics["loss"].item())
    finally:
        quant.commit_fp8_meta = real_commit
    result = {f"stat.{k}": v for k, v in stats_of(model.module).items()}
    result.update(losses=np.asarray(losses), local=np.stack(local),
                  committed=np.stack(committed), num_processes=acc.num_processes,
                  distributed_type=str(acc.distributed_type))
    if layout == "dp":  # after the three layouts, in main
        for axis, plugin in (("tp", dict(tp_plugin=TensorParallelPlugin(tp_size=2))),
                             ("pp", dict(pp_plugin=PipelineParallelPlugin(pp_size=2)))):
            AcceleratorState._reset_state()
            GradientState._reset_state()
            acc, model = build(inputs, **plugin)
            try:
                acc.prepare(model)
                result[f"refused_{axis}"] = ""
            except NotImplementedError as e:
                result[f"refused_{axis}"] = str(e)
    np.savez(out / f"{layout}_{acc.process_index}.npz", **result)


if __name__ == "__main__":
    out = Path(sys.argv[1])
    inputs = np.load(out / "fp8_in.npz")
    for layout in ("fsdp", "zero2", "dp"):
        run(layout, out, inputs)
