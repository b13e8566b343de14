"""The body of the port's expert-parallel tests, run in each process of a
gloo world by ``accelerate-tpu-torch launch --use_cpu_emulation``:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes N --ep 2 ... torch_moe_worker.py MODE OUT_DIR [ARG]

MODE is ``train``: for each case of the JSON ``ARG``, a fresh accelerator
with an ``ExpertParallelPlugin`` of the mesh's ``ep``, the tensor, context
and pipeline plugins of its ``tp``/``cp``/``pp`` above 1, and the case's
FSDP plugin trains the tiny Mixtral of ``OUT_DIR/<inputs>_in.npz``
(``moe`` unless the case names other inputs) under the case's
config for its steps; each rank's losses, grad norms, parameter and
Adam-moment chunks, and a ``save_state`` with the whole state dict where
the case asks (``setup`` also serves the resume in the test's own
process). Results go to
``OUT_DIR/<mode>_<rank>.npz``, each key prefixed by the case's name.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from accelerate_tpu_torch import (
    Accelerator,
    ContextParallelPlugin,
    ExpertParallelPlugin,
    FullyShardedDataParallelPlugin,
    GradientState,
    PartialState,
    PipelineParallelPlugin,
    TensorParallelPlugin,
)
from accelerate_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM, mixtral_lm_loss
from accelerate_tpu_torch.state import AcceleratorState


def rows_of(acc, array):
    """This process's data shard of a global batch's rows."""
    mesh = acc.mesh
    n, i = mesh.data_shards(), mesh.data_index()
    k = array.shape[0] // n
    return array[i * k:(i + 1) * k]


def setup(out: Path, case: dict):
    """A fresh accelerator (the mesh from the launcher's flags), the tiny
    Mixtral of ``moe_in.npz`` under ``case["config"]``, AdamW and the
    fused step."""
    AcceleratorState._reset_state()
    GradientState._reset_state()
    plugins = {"ep_plugin": ExpertParallelPlugin(ep_size=case.get("ep", 1))}
    if case.get("fsdp"):
        plugins["fsdp_plugin"] = FullyShardedDataParallelPlugin(
            sharding_strategy=case["fsdp"], activation_checkpointing=case.get("remat", False),
            min_weight_size_to_shard=1024)
    for axis, plugin in (("tp", TensorParallelPlugin), ("cp", ContextParallelPlugin),
                         ("pp", PipelineParallelPlugin)):
        if case.get(axis, 1) > 1:
            plugins[f"{axis}_plugin"] = plugin(**{f"{axis}_size": case[axis]})
    acc = Accelerator(cpu=True, **plugins)
    inputs = np.load(out / f"{case.get('inputs', 'moe')}_in.npz")
    config = MixtralConfig.tiny_moe(**case.get("config", {}))
    model = MixtralForCausalLM(config, device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    step = acc.compile_train_step(mixtral_lm_loss(model), max_grad_norm=1.0)

    def batch(s):
        return {"input_ids": torch.from_numpy(rows_of(acc, inputs["input_ids"][s])).long(),
                "labels": torch.from_numpy(rows_of(acc, inputs["labels"][s])).long()}

    return acc, model, opt, step, batch, inputs["input_ids"].shape[0]


def chunks(model, opt) -> dict:
    """Each parameter's and Adam moment's chunk, and their splits."""
    result = {f"param.{n}": p.detach().numpy() for n, p in model.module.named_parameters()}
    names = {id(p): n for n, p in model.module.named_parameters()}
    names.update({id(view): names[id(p)] for p, view, *_ in opt._views})
    layout = model.layout
    splits = {"param": {n: layout.splits[n] if layout is not None else {} for n in
                        (names[id(p)] for p in model.module.parameters())}, "moment": {}}
    for p, (split, _) in zip(opt._params(), opt.param_splits()):
        state = opt.optimizer.state.get(p, {})
        if "exp_avg" in state:
            result[f"mu.{names[id(p)]}"] = state["exp_avg"].numpy()
            result[f"nu.{names[id(p)]}"] = state["exp_avg_sq"].numpy()
            splits["moment"][names[id(p)]] = split
    result["splits"] = np.asarray(json.dumps(splits))
    return result


def run_train(out: Path, arg: str) -> dict:
    result = {}
    for name, case in json.loads(arg).items():
        acc, model, opt, step, batch, steps = setup(out, case)
        history, whole = [], {}
        for s in range(steps):
            m = step(batch(s))
            history.append([m["loss"].item(), m["grad_norm"].item()])
            if case.get("save_at") == s + 1:
                acc.save_state(str(out / case["save"]))
                whole = {f"whole.{k}": v.numpy().copy()
                         for k, v in acc.get_state_dict(model).items()}
        dropped = [c["dropped_fraction"].item() for c in model.module.routing_counters()]
        got = {"history": np.asarray(history), **whole, **chunks(model, opt),
               "dropped": np.asarray(dropped),
               "coords": np.asarray(json.dumps(acc.mesh.coords)),
               "specs": np.asarray(json.dumps({n: str(s) for n, s in model.layout.specs.items()})
                                   if model.layout is not None else "{}")}
        result.update({f"{name}.{k}": v for k, v in got.items()})
    return result


def main():
    mode, out = sys.argv[1], Path(sys.argv[2])
    arg = sys.argv[3] if len(sys.argv) > 3 else "{}"
    state = PartialState()
    result = {"train": run_train}[mode](out, arg)
    result["world"] = np.asarray(state.num_processes)
    np.savez(out / f"{mode}_{state.process_index}.npz", **result)
    print(f"{mode} ok on rank {state.process_index}", flush=True)


if __name__ == "__main__":
    main()
