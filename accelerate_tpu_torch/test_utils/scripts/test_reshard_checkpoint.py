"""Checkpoint resharding across process counts: save under one world,
restore under another.

Counterpart of ``accelerate_tpu/test_utils/scripts/test_reshard_checkpoint.py``.
Launched twice against one directory, with different process counts:

    accelerate-tpu-torch launch --use_cpu_emulation --num_processes 2 \\
        --module accelerate_tpu_torch.test_utils.scripts.test_reshard_checkpoint <dir> save
    accelerate-tpu-torch launch --use_cpu_emulation --num_processes 4 \\
        --module accelerate_tpu_torch.test_utils.scripts.test_reshard_checkpoint <dir> restore

The regression MLP trains under FSDP with ZeRO (every leaf that divides is
split over the processes), 4 steps, then ``save_state``; the save phase
records a checksum of every parameter and optimizer-state tensor, summed
over the processes' chunks. The restore phase, under another process
count and so another layout, must give the same checksums after
``load_state`` (which reads the chunks whole through host memory, as
``world.json`` names another world), then take one more step.
"""

import json
import os
import sys

import numpy as np
import torch


def _checksums(acc, model, opt) -> dict:
    """``sum(|x|)`` of every whole tensor: the parameters gathered, each
    optimizer-state tensor's chunks summed over the processes."""
    from accelerate_tpu_torch.utils.operations import reduce

    out = {f"params.{k}": float(v.double().abs().sum())
           for k, v in acc.get_state_dict(model).items()}
    layouts = opt.param_layouts()
    for pid, p in enumerate(opt._params()):
        dim, _ = layouts[pid]
        for key, value in sorted(opt.optimizer.state.get(p, {}).items()):
            if not isinstance(value, torch.Tensor):
                continue
            local = value.double().abs().sum()
            chunked = dim is not None and value.shape == p.shape
            out[f"opt.{pid}.{key}"] = float(reduce(local) if chunked else local)
    return out


def main():
    from accelerate_tpu_torch import Accelerator, PartialState, ProjectConfiguration
    from accelerate_tpu_torch.test_utils.training import (
        RegressionData,
        RegressionModel,
        init_mlp,
        mse_loss,
    )
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    state = PartialState()
    workdir, phase = sys.argv[1], sys.argv[2]
    acc = Accelerator(
        project_config=ProjectConfiguration(project_dir=workdir,
                                            automatic_checkpoint_naming=True),
        fsdp_plugin=FullyShardedDataParallelPlugin(min_weight_size_to_shard=1,
                                                   zero_sharding=True))
    model = RegressionModel(init_mlp(0, dh=64))
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05))
    step = acc.compile_train_step(mse_loss)

    data = RegressionData(32, seed=0)
    rows = 16 // acc.num_processes
    mine = data[rows * acc.process_index:rows * (acc.process_index + 1)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in mine])).to(acc.device)
             for k in mine[0]}

    expected_path = os.path.join(workdir, "expected_checksums.json")
    if phase == "save":
        for _ in range(4):
            metrics = step(batch)
        acc.save_state()
        sums = _checksums(acc, model, opt)
        if acc.is_main_process:
            with open(expected_path, "w") as f:
                json.dump({"checksums": sums, "loss": float(metrics["loss"]),
                           "world": state.num_processes}, f)
        acc.wait_for_everyone()
        print(f"saved under {state.num_processes} processes "
              f"(loss {float(metrics['loss']):.6f})", flush=True)
    elif phase == "restore":
        acc.load_state()
        with open(expected_path) as f:
            expected = json.load(f)
        assert expected["world"] != state.num_processes, (
            "reshard test must restore under a different process count")
        sums = _checksums(acc, model, opt)
        assert sums.keys() == expected["checksums"].keys(), (
            sorted(sums), sorted(expected["checksums"]))
        for key, want in expected["checksums"].items():
            got = sums[key]
            assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (key, got, want)
        print(f"restored under {state.num_processes} processes: "
              f"{len(sums)} tensor checksums match", flush=True)
        metrics = step(batch)  # the restored state trains in the new layout
        print(f"post-restore step ok (loss {float(metrics['loss']):.6f})", flush=True)
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    print("reshard-checkpoint phase complete.", flush=True)


if __name__ == "__main__":
    main()
