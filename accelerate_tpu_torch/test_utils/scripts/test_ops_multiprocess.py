"""The collectives of a process group, each on tensors of the process's
device (NCCL on the card, gloo on the CPU).

Counterpart of ``accelerate_tpu/test_utils/scripts/test_ops_multiprocess.py``,
with the same checks and printed lines, for torch:

    accelerate-tpu-torch launch --num_processes 2 --use_cpu_emulation \
        --module accelerate_tpu_torch.test_utils.scripts.test_ops_multiprocess

It runs at any world size, 1 included (a process group of one on one
card). "gather(global array)" gathers a sharded loader's batch, the
port's global batch. The debug shape check needs two processes to see a
mismatch; on one it checks that matched shapes pass. Every check raises on
a failure; exit 0 means the collectives work.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch


def main():
    from accelerate_tpu_torch import PartialState

    state = PartialState()  # joins the process group before anything else
    assert state.process_group, "run under accelerate-tpu-torch launch --num_processes N"
    from accelerate_tpu_torch.utils.operations import (
        broadcast,
        broadcast_object_list,
        gather,
        gather_object,
        pad_across_processes,
        reduce,
    )

    i, n, dev = state.process_index, state.num_processes, state.device
    print(f"accelerate-tpu-torch ops check: rank {i} of {n} on {dev} over {state.backend}")

    # gather: every process's rows, in rank order.
    everyone = gather(torch.full((2, 3), float(i), device=dev))
    assert everyone.device == dev and everyone.shape == (2 * n, 3), everyone.shape
    for p in range(n):
        assert torch.all(everyone[2 * p:2 * p + 2] == float(p))
    print(f"  [p{i}] gather ok")

    # gather of a sharded loader's batch: the global batch.
    from accelerate_tpu_torch import Accelerator, NumpyDataLoader

    acc = Accelerator()
    rows = [{"x": np.array([r], np.float32)} for r in range(4 * n)]
    batch = next(iter(acc.prepare_data_loader(NumpyDataLoader(rows, batch_size=2))))
    got = gather(batch["x"])
    assert got.device == dev and sorted(got.reshape(-1).tolist()) == [float(r) for r in
                                                                       range(2 * n)], got
    print(f"  [p{i}] gather(global array) ok (a sharded loader's batch)")

    objs = gather_object({"rank": i, "tag": "x" * (i + 1)})
    assert [o["rank"] for o in objs] == list(range(n))
    assert [len(o["tag"]) for o in objs] == [p + 1 for p in range(n)]
    print(f"  [p{i}] gather_object ok")

    out = broadcast(torch.full((4,), float(i * 10 + 7), device=dev))
    assert out.device == dev and torch.all(out == 7.0), out
    print(f"  [p{i}] broadcast ok")

    objs = broadcast_object_list([f"from-{i}", i * 100])
    assert objs == ["from-0", 0], objs
    print(f"  [p{i}] broadcast_object_list ok")

    total = reduce(torch.full((2,), float(i + 1), device=dev), reduction="sum")
    assert total.device == dev and torch.allclose(total.cpu(), torch.tensor(
        float(sum(range(1, n + 1)))))
    mean = reduce(torch.full((2,), float(i + 1), device=dev), reduction="mean")
    assert torch.allclose(mean.cpu(), torch.tensor(sum(range(1, n + 1)) / n))
    print(f"  [p{i}] reduce ok")

    padded = pad_across_processes(torch.ones((i + 1, 2), device=dev), dim=0)
    assert padded.shape == (n, 2) and padded.device == dev, padded.shape
    assert gather(padded).shape == (n * n, 2)
    print(f"  [p{i}] pad_across_processes ok")

    with state.split_between_processes(list(range(2 * n + 1)), apply_padding=True) as chunk:
        lens = gather_object(len(chunk))
        assert len(set(lens)) == 1, f"padding should equalize: {lens}"
    print(f"  [p{i}] split_between_processes ok")

    # Checkpoint round trip, every process taking part; the main process
    # picks the directory.
    from accelerate_tpu_torch.test_utils.training import (
        RegressionData,
        RegressionModel,
        mse_loss,
    )

    tmpdir = broadcast_object_list([tempfile.mkdtemp(prefix="atpu_torch_mp_ckpt_")
                                    if i == 0 else None])[0]
    model = RegressionModel()
    model, opt, loader = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.05),
                                     NumpyDataLoader(RegressionData(32), batch_size=8))
    acc.backward(mse_loss, next(iter(loader)))
    opt.step()
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    acc.save_state(tmpdir)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(5.0)
    acc.load_state(tmpdir)
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    print(f"  [p{i}] checkpoint round-trip ok")

    # The debug shape check: with two or more processes a rank-dependent
    # shape raises on every rank, naming each rank's shape.
    from accelerate_tpu_torch.utils.operations import DistributedOperationException

    before = PartialState._shared_state.get("debug", False)
    PartialState._shared_state["debug"] = True
    try:
        gather(torch.ones((2, 2), device=dev))  # matched shapes pass
        if n > 1:
            try:
                gather(torch.ones((i + 1, 2), device=dev))
            except DistributedOperationException as e:
                assert "shapes differ across processes" in str(e)
                assert f"Process {n - 1}" in str(e)
            else:
                raise AssertionError("the debug check let mismatched shapes through")
    finally:
        PartialState._shared_state["debug"] = before
    print(f"  [p{i}] debug shape sanitizer ok"
          + ("" if n > 1 else " (one process: matched shapes pass; no mismatch to see)"))

    acc.wait_for_everyone()
    if i == 0:
        print("All multi-process ops checks passed.")


if __name__ == "__main__":
    main()
