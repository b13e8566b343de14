"""The omnibus check of a process group.

Counterpart of ``accelerate_tpu/test_utils/scripts/test_script.py``, with
the same checks and printed lines, for torch:

    accelerate-tpu-torch launch --num_processes 2 --use_cpu_emulation \
        --module accelerate_tpu_torch.test_utils.scripts.test_script

(``accelerate-tpu-torch test`` runs it). Checks the state, seeded
determinism and the main process's random streams given to every process,
``split_between_processes``, the sharded loader's coverage, an exact
``gather_for_metrics``, the uneven tail under ``join_uneven_inputs``,
training in the group against the same updates on the global batch in one
process, and 2 x 8 accumulation against 1 x 16. Every check raises on a
failure; exit 0 means the world works.
"""

from __future__ import annotations

import numpy as np
import torch


def _fresh_accelerator(**kwargs):
    """A new accelerator in the same process group (the precision and
    accumulation state are reset, the process state is kept)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    return Accelerator(**kwargs)


def check_state(acc):
    from accelerate_tpu_torch.utils.dataclasses import DistributedType

    state = acc.state
    expected = "nccl" if acc.device.type == "cuda" else "gloo"
    assert state.backend == expected, (state.backend, expected)
    assert state.distributed_type in (DistributedType.MULTI_GPU, DistributedType.MULTI_CPU)
    assert torch.distributed.get_world_size() == acc.num_processes
    assert torch.distributed.get_rank() == acc.process_index
    print(f"  state ok: rank {acc.process_index} of {acc.num_processes} on {acc.device}, "
          f"{state.backend}")


def check_rng_determinism(acc):
    """``set_seed`` is reproducible; ``synchronize_rng_states`` gives every
    process the main process's torch and numpy streams."""
    from accelerate_tpu_torch.utils import gather_object, set_seed, synchronize_rng_states

    set_seed(42)
    a = torch.randn(4)
    set_seed(42)
    b = torch.randn(4)
    assert torch.equal(a, b)
    set_seed(7, device_specific=True)  # a different stream on every process
    synchronize_rng_states(["torch", "numpy"])
    draws = gather_object([(torch.rand(3).tolist(), np.random.rand(2).tolist())])
    assert all(d == draws[0] for d in draws), draws
    print("  rng determinism ok")


def check_split_between_processes(acc):
    n, i = acc.num_processes, acc.process_index
    with acc.split_between_processes(list(range(7)), apply_padding=False) as chunk:
        assert len(chunk) == 7 // n + (1 if i < 7 % n else 0), chunk
    print("  split_between_processes ok")


def _numbers(n):
    return [{"x": np.array([i], dtype=np.float32)} for i in range(n)]


def check_dataloader_sharding(acc):
    """Every sample is read once an epoch across the shards; the last round
    is completed by cycling from the start."""
    from accelerate_tpu_torch import NumpyDataLoader

    loader = acc.prepare_data_loader(NumpyDataLoader(_numbers(37), batch_size=8))
    seen = []
    for batch in loader:
        seen.extend(int(v) for v in acc.gather(batch["x"]).reshape(-1).tolist())
    assert set(seen) == set(range(37)), f"coverage hole: {sorted(set(range(37)) - set(seen))}"
    print(f"  dataloader sharding ok ({len(seen)} samples incl. padding)")


def check_gather_for_metrics(acc):
    """The padded duplicates of the last round are dropped."""
    from accelerate_tpu_torch import NumpyDataLoader

    loader = acc.prepare_data_loader(NumpyDataLoader(_numbers(37), batch_size=8))
    flat = torch.cat([acc.gather_for_metrics(b["x"]).reshape(-1).cpu() for b in loader])
    assert flat.tolist() == [float(i) for i in range(37)], flat.tolist()
    print("  gather_for_metrics ok (exact epoch reconstruction)")


def check_uneven_tail(acc):
    """``even_batches=False``: the processes read different numbers of
    batches, compute locally, and aggregate once after the loop."""
    from accelerate_tpu_torch import NumpyDataLoader

    loader = acc.prepare_data_loader(NumpyDataLoader(_numbers(37), batch_size=8),
                                     device_placement=False)
    sizes, local = [], []
    with acc.join_uneven_inputs([], even_batches=False):
        for batch in loader:
            x = np.asarray(batch["x"]).reshape(-1)
            sizes.append(len(x))
            local.extend(float(v) for v in x * 2.0)
    collected = acc.gather_for_metrics(local, use_gather_object=True)
    assert sorted(collected) == [float(2 * i) for i in range(37)], len(collected)
    short = acc.gather_for_metrics([s for s in sizes if s < 8], use_gather_object=True)
    assert short == [5], f"expected one 5-sample tail batch somewhere, got {short}"
    seen = sum(len(np.asarray(b["x"]).reshape(-1)) for b in loader)
    total = acc.gather_for_metrics([seen], use_gather_object=True)
    assert all(s == total[0] for s in total), f"even_batches not restored: {total}"
    print(f"  uneven tail ok (ragged sizes {sizes}, exact aggregation)")


def _train(acc, batch_size, steps=None, n_samples=64, lr=0.05):
    """The regression MLP trained by the loop a user writes, for ``steps``
    microbatches (default one epoch); returns the parameters and the
    losses on this process's batches."""
    from accelerate_tpu_torch import NumpyDataLoader
    from accelerate_tpu_torch.test_utils.training import RegressionData, RegressionModel, mse_loss

    model = RegressionModel()
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    loader = NumpyDataLoader(RegressionData(n_samples), batch_size=batch_size)
    model, opt, loader = acc.prepare(model, opt, loader)
    steps = len(loader) if steps is None else steps
    losses = []
    while len(losses) < steps:
        for batch in loader:
            with acc.accumulate(model):
                losses.append(float(acc.backward(mse_loss, batch)))
                opt.step()
                opt.zero_grad()
            if len(losses) == steps:
                break
    return {n: p.detach().cpu() for n, p in model.named_parameters()}, losses


def _train_in_one_process(steps, global_batch, lr=0.05):
    """The same updates on the global batch, in plain torch on the CPU."""
    from accelerate_tpu_torch.test_utils.training import RegressionData, RegressionModel, mse_loss

    data = RegressionData(64)
    model = RegressionModel()
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    starts = list(range(0, len(data), global_batch))
    for step in range(steps):
        chunk = data[starts[step % len(starts)]:][:global_batch]
        batch = {k: torch.as_tensor(np.stack([s[k] for s in chunk])) for k in chunk[0]}
        opt.zero_grad()
        mse_loss(dict(model.named_parameters()), batch).backward()
        opt.step()
    return {n: p.detach() for n, p in model.named_parameters()}


def check_training():
    """The group's updates equal one process's on the global batch, the
    loss falls, and every process holds the same parameters."""
    from accelerate_tpu_torch.utils import broadcast

    acc = _fresh_accelerator()
    n = acc.num_processes
    params, losses = _train(acc, batch_size=8, steps=8)
    reference = _train_in_one_process(steps=8, global_batch=8 * n)
    for name, value in params.items():
        torch.testing.assert_close(value, reference[name], rtol=1e-5, atol=1e-6)
        main = broadcast(value.to(acc.device)).cpu()
        assert torch.equal(main, value), f"{name} differs from the main process's"
    assert losses[-1] < losses[0], f"no convergence: {losses}"
    print(f"  training parity ok ({n} process(es) x batch 8 against one process x batch "
          f"{8 * n}; loss {losses[0]:.5f} -> {losses[-1]:.5f})")


def check_grad_accumulation():
    """2 microbatches of 8 accumulated equal one batch of 16."""
    from accelerate_tpu_torch.test_utils import assert_allclose_tree

    p_accum, _ = _train(_fresh_accelerator(gradient_accumulation_steps=2), batch_size=8,
                        n_samples=32)
    p_big, _ = _train(_fresh_accelerator(), batch_size=16, n_samples=32)
    assert_allclose_tree(p_accum, p_big, rtol=1e-5, atol=1e-6)
    print("  gradient accumulation ok (2x8 accum == 1x16)")


def main():
    from accelerate_tpu_torch import Accelerator, PartialState

    state = PartialState()  # joins the process group before anything else
    print(f"accelerate-tpu-torch omnibus check on {state.backend} ({state.device}), "
          f"{state.num_processes} process(es)")
    acc = Accelerator()
    check_state(acc)
    check_rng_determinism(acc)
    check_split_between_processes(acc)
    check_dataloader_sharding(acc)
    check_gather_for_metrics(acc)
    check_uneven_tail(acc)
    check_training()
    check_grad_accumulation()
    acc.wait_for_everyone()
    print("All omnibus checks passed.")


if __name__ == "__main__":
    main()
