"""The body of the port's fp8 world tests, run in each process of a gloo
world by ``accelerate-tpu-torch launch --use_cpu_emulation``:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes 2 torch_fp8_worker.py OUT_DIR

Each layout in turn, in one process group, starts from ``OUT_DIR/fp8_in.npz``
(the stacked tiny Llama's weights and statistics, with fp8 projections)
and takes AdamW steps on this process's rows of each global batch (all of
them where the mesh has no data axis above one):

* ``benchmarks/fp8.py``'s ``dp``, ``fsdp`` (FULL_SHARD, every leaf
  sharded) and ``zero2`` (a DeepSpeed ZeRO-2 config, translated onto
  FSDP), and ``tp`` (a tp plugin of 2) and ``pp`` (a pp plugin of 2, two
  microbatches): fused steps of the stacked model;
* ``tp_loop``: the sequential model at tp 2 in the user's loop
  (``backward`` + ``optimizer.step``, which commits through the
  optimizer's step hook).

Each commit's pending amaxes are kept as this process recorded them
(before the reduction) and slot 0 of the three histories after it, by
module; ``pp`` keeps the statistics after its first step too and saves its
state (``OUT_DIR/pp_ck``) at the end. Results go to
``OUT_DIR/<layout>_<rank>.npz``.
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
    LlamaForCausalLM,
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
    "tp": dict(tp_plugin=TensorParallelPlugin(tp_size=2)),
    "pp": dict(pp_plugin=PipelineParallelPlugin(pp_size=2, num_microbatches=2)),
    "tp_loop": dict(tp_plugin=TensorParallelPlugin(tp_size=2)),
}


def stats_of(module) -> dict:
    return {name: t.detach().clone().numpy() for name, t in module.state_dict().items()
            if name.rsplit(".", 1)[-1] in quant.FP8_META_NAMES}


def build(inputs, layout: str):
    acc = Accelerator(mixed_precision=str(inputs["precision"]), **PLUGINS[layout])
    state = {k[len("param."):]: torch.from_numpy(inputs[k])
             for k in inputs.files if k.startswith("param.")}
    if layout == "tp_loop":
        model = LlamaForCausalLM(LlamaConfig.tiny(**CONFIG), device="cpu")
        state = PipelinedLlamaForCausalLM.to_sequential_params(state)
    else:
        model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(**CONFIG), device="cpu")
    model.load_state_dict(state)
    return acc, model


def run(layout: str, out: Path, inputs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc, model = build(inputs, layout)
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    if layout == "tp_loop":
        loss_fn = fused_causal_lm_loss(model)

        def step(batch):
            loss = acc.backward(loss_fn, batch)
            opt.step()
            opt.zero_grad()
            return {"loss": loss}
    else:
        step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    local, committed = [], []
    real_commit = quant.commit_fp8_meta

    def commit(m):
        names = [n for n, mod in m.named_modules() if isinstance(mod, quant.Fp8Dense)]
        local.append({n: m.get_submodule(n).amax_pending.clone().numpy() for n in names})
        real_commit(m)
        committed.append({n: torch.stack([getattr(m.get_submodule(n), f"{kind}_amax_history")
                                          [..., 0] for kind in ("input", "kernel", "grad")],
                                         dim=-1).numpy() for n in names})

    quant.commit_fp8_meta = commit
    mesh = acc.state.mesh
    rows = inputs["input_ids"].shape[1] // mesh.data_shards()
    mine = slice(rows * mesh.data_index(), rows * (mesh.data_index() + 1))
    losses, result = [], {}
    try:
        for s in range(inputs["input_ids"].shape[0]):
            metrics = step({"input_ids": torch.from_numpy(inputs["input_ids"][s, mine]).long()})
            losses.append(float(metrics["loss"]))
            if s == 0:
                result.update({f"first.{k}": v for k, v in stats_of(model.module).items()})
    finally:
        quant.commit_fp8_meta = real_commit
    result.update({f"stat.{k}": v for k, v in stats_of(model.module).items()})
    for name in local[0]:
        result[f"local.{name}"] = np.stack([c[name] for c in local])
        result[f"committed.{name}"] = np.stack([c[name] for c in committed])
    result.update(losses=np.asarray(losses), num_processes=acc.num_processes,
                  distributed_type=str(acc.distributed_type))
    if layout == "pp":
        acc.save_state(str(out / "pp_ck"))
    np.savez(out / f"{layout}_{acc.process_index}.npz", **result)


if __name__ == "__main__":
    out = Path(sys.argv[1])
    inputs = np.load(out / "fp8_in.npz")
    for layout in ("fsdp", "zero2", "dp", "tp", "pp", "tp_loop"):
        run(layout, out, inputs)
