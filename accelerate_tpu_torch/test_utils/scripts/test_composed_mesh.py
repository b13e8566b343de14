"""A composed dp x fsdp mesh over the process group, driven through the
port's CLI.

Counterpart of ``accelerate_tpu/test_utils/scripts/test_composed_mesh.py``.
A JAX process holds several devices; a torch process holds one, so the
reference's 8 devices in 4 processes (``--dp 2 --fsdp 4``) become one
process a device. The test launches it at 4 processes, ``--dp 2 --fsdp 2``
(8 gloo processes would not fit the CPU test budget):

    accelerate-tpu-torch launch --use_cpu_emulation --num_processes 4 \
        --dp 2 --fsdp 2 --module accelerate_tpu_torch.test_utils.scripts.test_composed_mesh

The launcher passes ``FSDP_MIN_NUM_PARAMS=64`` through, so the tiny MLP
still shards. Checks:

* the mesh composes exactly as the flags say;
* prepared parameters are sharded over ``fsdp`` (a chunk smaller than the
  whole leaf) and replicated over ``dp`` (the two dp processes of one fsdp
  index hold the same chunk);
* the fused train step runs and the loss falls, and every process sees the
  same losses bit for bit;
* ``gather_for_metrics`` gives back an exact epoch of a 37-sample dataset
  over the composed global batch.
"""

import numpy as np


def main():
    import torch

    from accelerate_tpu_torch import Accelerator, NumpyDataLoader, PartialState
    from accelerate_tpu_torch.test_utils.training import (
        RegressionData,
        RegressionModel,
        init_mlp,
        mse_loss,
    )
    from accelerate_tpu_torch.utils.operations import gather_object

    state = PartialState()
    acc = Accelerator()
    shape = dict(acc.mesh.shape)
    print(f"composed mesh: {shape} over {state.num_processes} processes", flush=True)
    assert shape["dp"] == 2 and shape["fsdp"] == state.num_processes // 2, shape

    model = RegressionModel(init_mlp(dh=64))
    whole = {n: p.numel() for n, p in model.named_parameters()}
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.05))
    sharded = [n for n, p in model.module.named_parameters() if p.numel() < whole[n]]
    assert sharded, "no parameter leaf is fsdp-sharded"
    chunks = gather_object([(acc.mesh.coords["fsdp"],
                             {n: model.module.get_parameter(n).detach().numpy().tolist()
                              for n in sharded})])
    for coord, mine in chunks:
        twins = [other for c, other in chunks if c == coord]
        assert all(t == mine for t in twins), "dp does not replicate the fsdp chunks"
    print(f"  fsdp sharding ok ({len(sharded)} sharded leaves)", flush=True)

    data = RegressionData(64, seed=0)
    loader = acc.prepare(NumpyDataLoader(data, batch_size=4, shuffle=False))
    step = acc.compile_train_step(mse_loss)
    losses = []
    for _ in range(3):
        for batch in loader:
            metrics = step(batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, f"no convergence: {losses}"
    all_losses = gather_object([losses])
    assert all(l == all_losses[0] for l in all_losses), f"loss diverges: {all_losses}"
    print(f"  fused step over dp x fsdp ok (loss {losses[0]:.4f} -> {losses[-1]:.4f})",
          flush=True)

    n = 37
    ds = [{"x": np.array([i], dtype=np.float32)} for i in range(n)]
    mloader = acc.prepare_data_loader(NumpyDataLoader(ds, batch_size=2))
    collected = [np.asarray(acc.gather_for_metrics(batch["x"])).reshape(-1)
                 for batch in mloader]
    flat = np.concatenate(collected)
    assert len(flat) == n and set(int(v) for v in flat) == set(range(n)), len(flat)
    print("  gather_for_metrics over composed mesh ok", flush=True)
    print("composed-mesh checks passed.", flush=True)


if __name__ == "__main__":
    main()
