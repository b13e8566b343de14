"""The body of the port's multi-process tests, run in each process of a
gloo world by ``accelerate-tpu-torch launch --use_cpu_emulation``:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes 2 torch_mp_worker.py MODE OUT_DIR

MODE is ``mlp`` (the regression MLP, 8 steps of batch 8 a process),
``llama`` (the tiny Llama on ``OUT_DIR/llama_in.npz``: an evaluation on
uneven inputs, one ``backward`` and 3 fused train steps) or ``extras`` (the dispatcher, ``IterableDatasetShard``,
``LocalSGD``, ``check_trigger``, generator synchronisation and the fp16
skip decision) or ``reduce`` (the gradient reduction's buckets). Results go
to ``OUT_DIR`` as ``<mode>_<rank>.npz``; each mode prints "<mode> ok".
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, NumpyDataLoader, PartialState


def run_mlp(acc, out: Path):
    from accelerate_tpu_torch.test_utils.training import (
        RegressionData,
        RegressionModel,
        init_mlp,
        mse_loss,
    )

    model = RegressionModel(init_mlp(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    model, opt, loader = acc.prepare(model, opt, NumpyDataLoader(RegressionData(64),
                                                                 batch_size=8))
    steps = 0
    while steps < 8:
        for batch in loader:
            acc.backward(mse_loss, batch)
            opt.step()
            opt.zero_grad()
            steps += 1
            if steps == 8:
                break
    return {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}


def run_llama(acc, out: Path):
    from accelerate_tpu_torch import LlamaConfig, PipelinedLlamaForCausalLM, fused_causal_lm_loss
    from accelerate_tpu_torch.utils import gather_object

    inputs = np.load(out / "llama_in.npz")
    cfg = LlamaConfig.tiny()
    model = PipelinedLlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    loss_fn = fused_causal_lm_loss(model)

    # Evaluation on uneven inputs: 5 rows, batch 1 and even_batches=False,
    # so process 0 reads 3 batches and process 1 two. Each process calls
    # the loss alone, as an evaluation loop does, and the losses are
    # gathered once after the loop.
    rows = [{"row": np.int64(r), "input_ids": inputs["eval_ids"][r],
             "labels": inputs["eval_labels"][r]} for r in range(len(inputs["eval_ids"]))]
    loader = acc.prepare_data_loader(NumpyDataLoader(rows, batch_size=1))
    params = dict(model.module.named_parameters())
    seen = []
    with acc.join_uneven_inputs([model], even_batches=False), torch.no_grad():
        for batch in loader:
            loss = loss_fn(params, {k: batch[k].long() for k in ("input_ids", "labels")})
            seen.append([float(batch["row"][0]), loss.item()])
    assert len(seen) == (3 if acc.process_index == 0 else 2), seen
    evaluated = sorted(gather_object(seen))

    rows = inputs["input_ids"].shape[1] // acc.num_processes
    mine = slice(rows * acc.process_index, rows * (acc.process_index + 1))
    first = {"input_ids": torch.from_numpy(inputs["input_ids"][0, mine]).long(),
             "labels": torch.from_numpy(inputs["labels"][0, mine]).long()}
    backward_loss = acc.backward(loss_fn, first).item()  # the step below starts from zero
    step = acc.compile_train_step(loss_fn, max_grad_norm=1.0)
    history = []
    for s in range(inputs["input_ids"].shape[0]):
        batch = {"input_ids": torch.from_numpy(inputs["input_ids"][s, mine]).long(),
                 "labels": torch.from_numpy(inputs["labels"][s, mine]).long()}
        metrics = step(batch)
        history.append([metrics["loss"].item(), metrics["grad_norm"].item()])
    result = {f"param.{n}": p.detach().numpy() for n, p in model.module.named_parameters()}
    result["history"] = np.asarray(history)
    result["evaluated"] = np.asarray(evaluated)
    result["backward_loss"] = np.asarray(backward_loss)
    return result


class _Counting(torch.utils.data.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


def run_extras(acc, out: Path):
    from accelerate_tpu_torch import DataLoaderConfiguration, LocalSGD
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.test_utils.training import RegressionData, RegressionModel, mse_loss
    from accelerate_tpu_torch.utils import gather, gather_object, synchronize_rng_states

    n, i = acc.num_processes, acc.process_index
    rows = [{"x": np.array([r], np.float32)} for r in range(21)]

    # Dispatched: the main process reads; every process gets its slice and
    # gather_for_metrics rebuilds the epoch exactly.
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator(dataloader_config=DataLoaderConfiguration(dispatch_batches=True))
    loader = acc.prepare_data_loader(NumpyDataLoader(rows, batch_size=4))
    seen = [acc.gather_for_metrics(b["x"]).reshape(-1) for b in loader]
    assert torch.cat(seen).tolist() == [float(r) for r in range(21)], seen
    assert len(loader) == len(seen)

    # A torch loader over an iterable dataset reads through
    # IterableDatasetShard: batch 3 a process, the last round cycled.
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator()
    loader = acc.prepare(torch.utils.data.DataLoader(_Counting(20), batch_size=3))
    got = torch.cat([gather(b) for b in loader]).tolist()
    assert got[:20] == list(range(20)) and len(got) == 24 and got[20:] == [0, 1, 2, 3], got

    # A shuffled torch loader draws one order on every process.
    loader = acc.prepare(torch.utils.data.DataLoader(list(range(16)), batch_size=2,
                                                     shuffle=True))
    order = torch.cat([gather(b) for b in loader]).tolist()
    assert sorted(order) == list(range(16)) and order != list(range(16)), order

    # The main process's generator state reaches every process.
    gen = torch.Generator().manual_seed(100 + i)
    synchronize_rng_states(["generator"], generator=gen)
    draws = gather_object([torch.rand(2, generator=gen).tolist()])
    assert all(d == draws[0] for d in draws), draws

    # check_trigger: one process sets it, every process sees it, once.
    if i == n - 1:
        acc.set_trigger()
    assert acc.check_trigger() and not acc.check_trigger()

    # LocalSGD under AdamW, a batch of its own on every process, averaged
    # after step 2 and on leaving: every process's parameters after each
    # of 3 steps, and its Adam moments before and after leaving, go to the
    # test, which holds them against the JAX package's LocalSGD.
    model = RegressionModel()
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05,
                                                      betas=(0.5, 0.75), weight_decay=1e-4))
    data = RegressionData(16, seed=10 + i)  # another batch on every process
    batch = {k: torch.as_tensor(np.stack([s[k] for s in data])) for k in data[0]}
    named = list(model.module.named_parameters())

    def moments():
        return {f"{k}.{name}": opt.optimizer.state[p][k].clone().numpy()
                for name, p in named for k in ("exp_avg", "exp_avg_sq")}

    lsgd = {}
    with LocalSGD(acc, model, opt, mse_loss, local_sgd_steps=2) as local:
        for s in range(3):
            local.step(batch)
            lsgd.update({f"lsgd.step{s}.{name}": p.detach().clone().numpy()
                         for name, p in named})
        lsgd.update({f"lsgd.local.{k}": v for k, v in moments().items()})
    lsgd.update({f"lsgd.exit.{name}": p.detach().clone().numpy() for name, p in named})
    lsgd.update({f"lsgd.exit.{k}": v for k, v in moments().items()})

    # fp16: one process's gradient overflows, and every process skips the
    # update (one decision on the all-reduced flag).
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="fp16")
    fp16 = RegressionModel()
    fp16, opt16 = acc.prepare(fp16, torch.optim.SGD(fp16.parameters(), lr=0.05))
    batch = {"x": batch["x"].half(), "y": batch["y"]}
    if i == n - 1:
        batch["x"][0, 0] = float("inf")
    acc.backward(mse_loss, batch)
    opt16.step()
    assert opt16.step_was_skipped and opt16.steps_applied == 0
    return {"fp16_w1": fp16.module.w1.detach().numpy(), **lsgd}


def run_reduce(acc, out: Path):
    """``_reduce_gradients`` against the sum computed here from every
    process's seeded inputs: buckets of one tensor (reduced in place), of
    several (flattened), a non-contiguous view, the loss riding along or
    reduced alone, in f32 and in bf16."""
    from accelerate_tpu_torch.accelerator import _reduce_gradients

    shapes = [(1000,), (3, 4), (50000,), (7,), (40, 30)]

    def inputs(rank, view):
        gen = torch.Generator().manual_seed(rank)
        grads = [torch.randn(shape, generator=gen) for shape in shapes]
        if view:
            grads[-1] = grads[-1].t()  # non-contiguous: flattened, copied back
        return grads, torch.tensor([rank + 1.0, 2.0])

    cases = [(cap, dtype, view) for cap in (0, 0.1, 25) for dtype in (None, torch.bfloat16)
             for view in (True, False)]
    for cap, dtype, view in cases:
        every = [inputs(r, view) for r in range(acc.num_processes)]
        grads, extras = inputs(acc.process_index, view)
        reduced = _reduce_gradients(grads, 0.5, cap, dtype=dtype, extras=extras)
        for k, g in enumerate(grads):
            want = sum(e[0][k] for e in every) * 0.5
            tol = 0 if dtype is None else 2e-2
            torch.testing.assert_close(g, want, rtol=tol, atol=tol, msg=f"{cap} {dtype} {k}")
        torch.testing.assert_close(reduced, sum(e[1] for e in every) * 0.5, rtol=0, atol=0)
    return {}


def main():
    mode, out = sys.argv[1], Path(sys.argv[2])
    state = PartialState()
    acc = Accelerator()
    result = {"mlp": run_mlp, "llama": run_llama, "extras": run_extras,
              "reduce": run_reduce}[mode](acc, out)
    np.savez(out / f"{mode}_{state.process_index}.npz", **result)
    (out / f"{mode}_{state.process_index}.json").write_text(json.dumps(
        {"backend": state.backend, "world": state.num_processes}))
    print(f"{mode} ok on rank {state.process_index}", flush=True)


if __name__ == "__main__":
    main()
