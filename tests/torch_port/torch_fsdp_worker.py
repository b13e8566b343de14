"""The body of the port's sharded-training tests, run in each process of a
gloo world by ``accelerate-tpu-torch launch --use_cpu_emulation``:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes N torch_fsdp_worker.py MODE OUT_DIR [ARG]

MODE is ``llama`` (the tiny stacked Llama on ``OUT_DIR/llama_in.npz``, 6
fused AdamW steps under the FSDP plugin named by ARG: ``env`` takes the
default plugin that ``launch --fsdp`` and the ``FSDP_*`` variables ask
for; then ``save_state`` and the gathered state dict), ``save`` (the ZeRO
regression MLP: 3 steps, ``save_state`` to ``OUT_DIR/ck``, 6 more steps,
then ``load_state`` of the same world and the 6 steps again; then a deep,
narrow stacked Llama split over its layer axis, with and without FSDP) or
``restore`` (``load_state(via_host=True)`` of ``OUT_DIR/ck`` in this world,
then 6 steps). Results go to ``OUT_DIR`` as ``<mode>_<rank>.npz``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, PartialState

STRATEGIES = {
    "full": dict(sharding_strategy="FULL_SHARD", zero_sharding=True, activation_checkpointing=True),
    "grad_op": dict(sharding_strategy="SHARD_GRAD_OP", zero_sharding=True,
                    activation_checkpointing=True),
    "no_shard": dict(sharding_strategy="NO_SHARD", zero_sharding=True),
}


def run_llama(out: Path, strategy: str):
    from accelerate_tpu_torch import LlamaConfig, PipelinedLlamaForCausalLM, fused_causal_lm_loss

    plugin = None if strategy == "env" else FullyShardedDataParallelPlugin(**STRATEGIES[strategy])
    acc = Accelerator(fsdp_plugin=plugin)
    inputs = np.load(out / "llama_in.npz")
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    rows = inputs["input_ids"].shape[1] // acc.num_processes
    mine = slice(rows * acc.process_index, rows * (acc.process_index + 1))
    history = []
    for s in range(inputs["input_ids"].shape[0]):
        metrics = step({"input_ids": torch.from_numpy(inputs["input_ids"][s, mine]).long(),
                        "labels": torch.from_numpy(inputs["labels"][s, mine]).long()})
        history.append([metrics["loss"].item(), metrics["grad_norm"].item()])
    result = {f"param.{n}": p.detach().numpy() for n, p in model.module.named_parameters()}
    names = {id(p): n for n, p in model.module.named_parameters()}
    names.update({id(view): names[id(p)] for p, view, *_ in opt._views})
    for p in opt._params():
        state = opt.optimizer.state[p]
        result[f"mu.{names[id(p)]}"] = state["exp_avg"].numpy()
        result[f"nu.{names[id(p)]}"] = state["exp_avg_sq"].numpy()
    result["history"] = np.asarray(history)
    result["param_bytes"] = np.asarray(sum(p.numel() * p.element_size()
                                           for p in model.module.parameters()))
    result["moment_bytes"] = np.asarray(opt.state_bytes())
    result["gathers"] = np.asarray(model.layout.gathers)
    result["strategy"] = np.asarray(acc.fsdp_plugin.sharding_strategy)
    result["zero"] = np.asarray(acc.zero_sharding)
    result["distributed_type"] = np.asarray(str(acc.distributed_type))
    acc.save_state(str(out / "llama_ck"))
    for name, tensor in acc.get_state_dict(model).items():
        result[f"whole.{name}"] = tensor.numpy()
    return result


def mlp_setup(acc):
    from accelerate_tpu_torch.test_utils.training import RegressionModel, init_mlp, mse_loss

    model = RegressionModel(init_mlp(0, dh=512))
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05))
    step = acc.compile_train_step(mse_loss, max_grad_norm=1.0)
    batch = mlp_batch(acc.process_index, acc.num_processes)
    return model, opt, step, batch


def mlp_batch(rank: int, world: int, n: int = 32) -> dict:
    """Rows ``rank`` of ``world`` of the seeded regression batch."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = x @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    rows = n // world
    return {"x": torch.from_numpy(x[rank * rows:(rank + 1) * rows]),
            "y": torch.from_numpy(y[rank * rows:(rank + 1) * rows])}


ZERO = dict(sharding_strategy="NO_SHARD", zero_sharding=True)


def deep_narrow_llama(plugin) -> list:
    """3 steps of a stacked Llama whose layer axis (64) is every leaf's
    largest, so FSDP splits the layers themselves: the stacked leaves are
    gathered whole before the layer loop. Returns the losses."""
    from accelerate_tpu_torch import LlamaConfig, PipelinedLlamaForCausalLM, fused_causal_lm_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator(fsdp_plugin=plugin)
    cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=64,
                      num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64)
    model = PipelinedLlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    if plugin is not None:
        assert model.layout.dims["model.blocks.mlp.up_proj.weight"] == 0
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (4, 8)))
    mine = ids[2 * acc.process_index:2 * acc.process_index + 2]
    return [step({"input_ids": mine})["loss"].item() for _ in range(3)]


def run_save(out: Path, _):
    acc = Accelerator(fsdp_plugin=FullyShardedDataParallelPlugin(**ZERO))
    model, opt, step, batch = mlp_setup(acc)
    for _ in range(3):
        step(batch)
    acc.save_state(str(out / "ck"))
    reference = [step(batch)["loss"].item() for _ in range(6)]
    acc.load_state(str(out / "ck"))  # the same world: each process reads its own file
    again = [step(batch)["loss"].item() for _ in range(6)]
    layers = deep_narrow_llama(FullyShardedDataParallelPlugin(min_weight_size_to_shard=1))
    return {"reference": np.asarray(reference), "again": np.asarray(again),
            "views": np.asarray(len(opt._views)), "layer_axis": np.asarray(layers),
            "layer_axis_unsharded": np.asarray(deep_narrow_llama(None))}


def run_restore(out: Path, _):
    acc = Accelerator(fsdp_plugin=FullyShardedDataParallelPlugin(**ZERO))
    model, opt, step, batch = mlp_setup(acc)
    acc.load_state(str(out / "ck"), via_host=True)
    return {"losses": np.asarray([step(batch)["loss"].item() for _ in range(6)])}


def main():
    mode, out = sys.argv[1], Path(sys.argv[2])
    arg = sys.argv[3] if len(sys.argv) > 3 else None
    state = PartialState()
    result = {"llama": run_llama, "save": run_save, "restore": run_restore}[mode](out, arg)
    result["world"] = np.asarray(state.num_processes)
    np.savez(out / f"{mode}_{state.process_index}.npz", **result)
    print(f"{mode} ok on rank {state.process_index}", flush=True)


if __name__ == "__main__":
    main()
