"""The port's training loop against the JAX package's.

The loop a user writes (``accumulate``, ``backward``, ``clip_grad_norm_`` at
the sync step, the prepared optimizer's ``step``/``zero_grad`` and a
scheduler's ``step``) on both sides, from the same weights and the same
numpy batches:

* a tiny Llama in fp32 (weights through ``utils/convert.py``), accumulation
  2, an ``LRScheduler`` warmup, ``torch.optim.AdamW`` against
  ``optax.inject_hyperparams(optax.adamw)``: losses, grad norms, learning
  rates and final parameters within the fp32 tolerances of
  ``test_torch_train_step.py`` (``FP32``: relative 1e-4 on loss and grad
  norm, weights within 5e-5, each tensor's update within 5e-3 relative);
* the JAX package's ``TestTrainingLoop`` cases mirrored on an MLP: the loss
  falls (and follows the JAX loop's within 1e-5 relative: SGD, fp32, the
  same arithmetic in another order), accumulation 4 x 4 equals a batch of
  16, the clip, the fp16 skip;
* the same Llama loop without ``zero_grad``, at accumulation 1 and 2: every
  update consumes its gradients on both sides, so it still follows the JAX
  loop at ``FP32``;
* the loop's first update equal to ``compile_train_step``'s on the same two
  microbatches;
* the remat policies: "dots" gives the no-remat gradients (within 1e-6 at
  fp32) without recomputing a projection and through no dispatch mode,
  "everything" recomputes nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.data_loader import NumpyDataLoader as JaxNumpyDataLoader
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
from accelerate_tpu.models.llama import fused_causal_lm_loss as jax_fused_causal_lm_loss
from accelerate_tpu.scheduler import LRScheduler as JaxLRScheduler
from accelerate_tpu_torch import (
    Accelerator,
    GradScalerKwargs,
    LlamaConfig,
    LlamaForCausalLM,
    LRScheduler,
    NumpyDataLoader,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
    fused_causal_lm_loss,
    resolve_remat_policy,
    state_dict_from_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState

FP32 = dict(loss=1e-4, grad_norm=1e-4, update=5e-3, params=5e-5)


def reset_port_state():
    """A second accelerator in one test starts from fresh singletons."""
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def warmup(count):
    """Two warmup steps, then flat."""
    return 1e-3 * min(1.0, (count + 1) / 3)


def llama_params(seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        JaxPipelined(JaxLlamaConfig.tiny()).init_params(jax.random.PRNGKey(seed)))


def token_rows(n=16, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, seq).astype(np.int32)} for _ in range(n)]


def jax_llama_loop(params, rows, accum=2, zero_grad=True):
    module = JaxPipelined(JaxLlamaConfig.tiny())
    acc = JaxAccelerator(gradient_accumulation_steps=accum)
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=warmup(0))
    model, opt, loader, sched = acc.prepare(Model(module, params), tx,
                                            JaxNumpyDataLoader(rows, batch_size=2),
                                            JaxLRScheduler(warmup))
    loss_fn = jax_fused_causal_lm_loss(module)
    losses, norms, lrs = [], [], []
    for batch in loader:
        with acc.accumulate(model):
            losses.append(float(acc.backward(loss_fn, batch)))
            if acc.sync_gradients:
                norms.append(float(acc.clip_grad_norm_(max_norm=1.0)))
            opt.step()
            sched.step()
            if zero_grad:
                opt.zero_grad()
            if acc.sync_gradients:
                lrs.append(float(opt.opt_state.hyperparams["learning_rate"]))
    return losses, norms, lrs, jax.device_get(model.params)


def port_llama_loop(params, rows, accum=2, zero_grad=True):
    cfg = LlamaConfig.tiny()
    module = PipelinedLlamaForCausalLM(cfg, device="cpu")
    module.load_state_dict(state_dict_from_flax(params, cfg))
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum)
    model, opt, loader, sched = acc.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=warmup(0), weight_decay=1e-4),
        NumpyDataLoader(rows, batch_size=2), LRScheduler(warmup))
    loss_fn = fused_causal_lm_loss(model)
    losses, norms, lrs = [], [], []
    for batch in loader:
        with acc.accumulate(model):
            losses.append(acc.backward(loss_fn, batch).item())
            if acc.sync_gradients:
                norms.append(acc.clip_grad_norm_(max_norm=1.0).item())
            opt.step()
            sched.step()
            if zero_grad:
                opt.zero_grad()
            if acc.sync_gradients:
                lrs.append(opt.param_groups[0]["lr"])
    assert opt.steps_applied == len(norms) and sched.scheduler.count == len(norms)
    return losses, norms, lrs, module.state_dict()


def test_llama_loop_follows_the_jax_loop():
    params, rows = llama_params(), token_rows()
    ref_losses, ref_norms, ref_lrs, ref_params = jax_llama_loop(params, rows)
    losses, norms, lrs, state = port_llama_loop(params, rows)
    assert len(losses) == 8 and len(norms) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=FP32["loss"])
    np.testing.assert_allclose(norms, ref_norms, rtol=FP32["grad_norm"])
    # The schedule's values; the JAX side holds them in f32.
    assert lrs == [warmup(1), warmup(2), warmup(3), warmup(4)]
    np.testing.assert_allclose(lrs, ref_lrs, rtol=1e-7)
    assert_same_params(params, ref_params, state)


@pytest.mark.parametrize("accum", [1, 2])
def test_llama_loop_without_zero_grad_follows_the_jax_loop(accum):
    """``step()`` consumes the gradients it applied: a loop that never calls
    ``zero_grad`` trains as the JAX loop does, whose accumulator is dropped
    at every sync-step update."""
    params, rows = llama_params(), token_rows()
    ref_losses, ref_norms, _, ref_params = jax_llama_loop(params, rows, accum, zero_grad=False)
    losses, norms, _, state = port_llama_loop(params, rows, accum, zero_grad=False)
    assert len(losses) == 8 and len(norms) == 8 // accum
    np.testing.assert_allclose(losses, ref_losses, rtol=FP32["loss"])
    np.testing.assert_allclose(norms, ref_norms, rtol=FP32["grad_norm"])
    assert_same_params(params, ref_params, state)


def assert_same_params(params, ref_params, state):
    """The port's final weights against the JAX loop's, at ``FP32``."""
    initial = state_dict_from_flax(params, LlamaConfig.tiny())
    expected = state_dict_from_flax(ref_params, LlamaConfig.tiny())
    for name, tensor in expected.items():
        np.testing.assert_allclose(state[name].numpy(), tensor.numpy(), atol=FP32["params"],
                                   rtol=0, err_msg=name)
        update, ref_update = state[name] - initial[name], tensor - initial[name]
        assert ((update - ref_update).norm() / ref_update.norm()).item() <= FP32["update"], name


# -- the JAX package's TestTrainingLoop, on an MLP ---------------------------

def regression_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = np.array([[1.0], [-2.0], [0.5], [3.0]], dtype=np.float32)
    y = x @ w + 0.1 * rng.normal(size=(n, 1)).astype(np.float32)
    return [{"x": x[i], "y": y[i]} for i in range(n)]


def mlp_init(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": np.asarray(jax.random.normal(k1, (4, 16)) * 0.3), "b1": np.zeros(16, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (16, 1)) * 0.3), "b2": np.zeros(1, np.float32)}


class MLP(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for name, value in init.items():
            setattr(self, name, torch.nn.Parameter(torch.tensor(np.asarray(value))))


def mse_loss(p, batch):
    x, y = (batch[k].to(p["w1"].dtype) for k in ("x", "y"))  # the compute dtype
    pred = torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return ((pred.float() - y.float()) ** 2).mean()


def jax_mse_loss(p, batch):
    pred = jnp.tanh(batch["x"] @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return jnp.mean((pred - batch["y"]) ** 2)


def mlp_loop(acc, data, batch_size=8, lr=0.05, epochs=2, clip=None, loss_fn=mse_loss):
    module = MLP(mlp_init())
    model, opt, loader = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=lr),
                                     NumpyDataLoader(data, batch_size=batch_size))
    losses = []
    for _ in range(epochs):
        for batch in loader:
            with acc.accumulate(model):
                losses.append(acc.backward(loss_fn, batch).item())
                if clip is not None and acc.sync_gradients:
                    acc.clip_grad_norm_(max_norm=clip)
                opt.step()
                opt.zero_grad()
    return module, opt, losses


def test_mlp_loss_falls_as_in_jax():
    _, opt, losses = mlp_loop(Accelerator(cpu=True), regression_data())
    jax_acc = JaxAccelerator()
    model, jopt, loader = jax_acc.prepare(Model(lambda p, x: None, mlp_init()), optax.sgd(0.05),
                                          JaxNumpyDataLoader(regression_data(), batch_size=8))
    ref = []
    for _ in range(2):
        for batch in loader:
            with jax_acc.accumulate(model):
                ref.append(float(jax_acc.backward(jax_mse_loss, batch)))
                jopt.step()
                jopt.zero_grad()
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    assert sum(losses[8:]) < 0.5 * sum(losses[:8])
    assert opt.steps_applied == len(losses)


def test_mlp_accumulation_4x4_equals_a_batch_of_16():
    data = regression_data(32)
    accum, opt, _ = mlp_loop(Accelerator(cpu=True, gradient_accumulation_steps=4), data,
                             batch_size=4, lr=0.1, epochs=1)
    assert opt.steps_applied == 2
    reset_port_state()
    big, opt_big, _ = mlp_loop(Accelerator(cpu=True), data, batch_size=16, lr=0.1, epochs=1)
    assert opt_big.steps_applied == 2
    for a, b in zip(accum.parameters(), big.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=2e-5)


def test_mlp_clip_grad_norm():
    acc = Accelerator(cpu=True)
    module = MLP(mlp_init())
    model, opt, loader = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=1.0),
                                     NumpyDataLoader(regression_data(8), batch_size=8))
    before = [p.detach().clone() for p in module.parameters()]
    batch = next(iter(loader))
    with acc.accumulate(model):
        acc.backward(mse_loss, batch)
        gnorm = acc.clip_grad_norm_(max_norm=0.001)
        clipped = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in module.parameters()]))
        opt.step()
        opt.zero_grad()
    assert gnorm.item() > 0.001 and clipped.item() <= 0.001 * 1.01
    delta = max((p.detach() - b).abs().max().item() for p, b in zip(module.parameters(), before))
    assert delta <= 0.0011


def test_mlp_fp16_non_finite_step_is_skipped():
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[GradScalerKwargs(init_scale=4.0)])
    module = MLP(mlp_init())
    model, opt, loader = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1),
                                     NumpyDataLoader(regression_data(8), batch_size=8))
    before = [p.detach().clone() for p in module.parameters()]
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(lambda p, b: p["w1"].float().mean() * float("nan"), batch)
            opt.step()
            opt.zero_grad()
    assert opt.step_was_skipped and opt.steps_applied == 0
    for p, b in zip(module.parameters(), before):
        assert torch.equal(p.detach(), b)
    assert opt.loss_scale.scale.item() == 2.0


def test_mlp_fp16_loop_trains_and_unscales_once():
    acc = Accelerator(cpu=True, mixed_precision="fp16")
    _, opt, losses = mlp_loop(acc, regression_data(), clip=10.0)
    assert opt.loss_scale.scale.item() > 0 and opt.steps_applied > 0
    assert sum(losses[8:]) < sum(losses[:8])


def test_scheduler_steps_with_the_optimizer():
    """4 batches, accumulation 2: two updates, two scheduler steps (the JAX
    package's TestSchedulers), and a torch scheduler is gated the same way."""
    for make in ("native", "torch"):
        reset_port_state()
        acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
        module = MLP(mlp_init())
        torch_opt = torch.optim.SGD(module.parameters(), lr=0.1)
        sched = (LRScheduler(lambda c: 0.1 * (1 - c / 8)) if make == "native"
                 else torch.optim.lr_scheduler.LambdaLR(torch_opt, lambda c: 1 - c / 8))
        model, opt, loader, sched = acc.prepare(module, torch_opt,
                                                NumpyDataLoader(regression_data(16), batch_size=4),
                                                sched)
        for batch in loader:
            with acc.accumulate(model):
                acc.backward(mse_loss, batch)
                opt.step()
                sched.step()
                opt.zero_grad()
        assert opt.steps_applied == 2
        assert opt.param_groups[0]["lr"] == pytest.approx(0.1 * (1 - 2 / 8))
        if make == "native":
            assert sched.scheduler.count == 2


def test_gather_for_metrics_drops_the_padding_of_an_uneven_last_batch():
    acc = Accelerator(cpu=True)
    ids = np.arange(10, dtype=np.int32)
    loader = acc.prepare(NumpyDataLoader([{"id": i} for i in ids], batch_size=4))
    gathered = [acc.gather_for_metrics(batch["id"]) for batch in loader]
    assert [len(g) for g in gathered] == [4, 4, 2]
    assert torch.cat(gathered).tolist() == ids.tolist()
    # On the last batch the remainder (10 % 4) truncates a wider tensor.
    loader = acc.prepare(NumpyDataLoader([{"id": i} for i in ids], batch_size=4))
    for i, batch in enumerate(loader):
        if i == 2:
            assert acc.gather_for_metrics(torch.arange(4)).tolist() == [0, 1]
            assert acc.gather_for_metrics([7, 8, 9, 10], use_gather_object=True) == [7, 8]
    assert acc.gather_for_metrics(torch.arange(4)).shape == (4,)  # outside a loader


def test_loop_first_update_is_the_fused_steps():
    """The same two microbatches through the loop (accumulation 2, clip at
    the sync step) and through compile_train_step: equal loss, grad norm and
    parameters after the update."""
    params, rows = llama_params(), token_rows(4)
    cfg = LlamaConfig.tiny()
    results = []
    for fused in (False, True):
        reset_port_state()
        module = PipelinedLlamaForCausalLM(cfg, device="cpu")
        module.load_state_dict(state_dict_from_flax(params, cfg))
        acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
        model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3,
                                                           weight_decay=1e-4))
        batches = [{"input_ids": torch.from_numpy(np.stack([r["input_ids"] for r in rows[i:i + 2]]))
                    .long()} for i in (0, 2)]
        if fused:
            step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
            metrics = step({"input_ids": torch.stack([b["input_ids"] for b in batches])})
            loss, gnorm = metrics["loss"], metrics["grad_norm"]
        else:
            loss_fn, losses = fused_causal_lm_loss(model), []
            for b in batches:
                with acc.accumulate(model):
                    losses.append(acc.backward(loss_fn, b))
                    if acc.sync_gradients:
                        gnorm = acc.clip_grad_norm_(max_norm=1.0)
                    opt.step()
                    opt.zero_grad()
            loss = (losses[0] + losses[1]) / 2
        results.append((loss, gnorm, {n: p.detach().clone() for n, p in module.named_parameters()}))
    (loss, gnorm, state), (ref_loss, ref_gnorm, ref_state) = results
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * abs(ref_loss.item())
    assert torch.equal(gnorm, ref_gnorm)
    for name, tensor in ref_state.items():
        assert torch.equal(state[name], tensor), name


# -- remat policies ------------------------------------------------------------

def test_resolve_remat_policy_names():
    from accelerate_tpu_torch.parallel.sharding import RematPolicy

    assert resolve_remat_policy("dots") is RematPolicy.DOTS
    assert resolve_remat_policy("nothing") is RematPolicy.NOTHING
    assert resolve_remat_policy("everything") is RematPolicy.EVERYTHING
    with pytest.raises(ValueError, match="unknown remat_policy"):
        resolve_remat_policy("some")


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def backward_mm_count(cls, remat, policy, flash=False):
    """Gradients and the aten.mm calls of the backward of one loss."""
    model = cls(LlamaConfig.tiny(remat=remat, remat_policy=policy), device="cpu",
                generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.stack([r["input_ids"] for r in token_rows(2)])).long()
    loss = causal_lm_loss(model)(dict(model.named_parameters()), {"input_ids": ids})
    with CountOps() as ops:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return grads, ops.counts.get(torch.ops.aten.mm.default, 0)


@pytest.mark.parametrize("cls", [PipelinedLlamaForCausalLM, LlamaForCausalLM],
                         ids=["stacked", "sequential"])
def test_dots_remat_recomputes_no_projection(cls):
    plain, plain_mm = backward_mm_count(cls, False, "dots")
    dots, dots_mm = backward_mm_count(cls, True, "dots")
    nothing, nothing_mm = backward_mm_count(cls, True, "nothing")
    assert dots_mm == plain_mm  # the backward's own products only
    assert nothing_mm > plain_mm  # the whole layer recomputed, projections too
    for name, g in plain.items():
        torch.testing.assert_close(dots[name], g, atol=1e-6, rtol=0)
        torch.testing.assert_close(nothing[name], g, atol=1e-6, rtol=0)


def test_dots_remat_recomputes_the_flash_forward(monkeypatch):
    """The kernel route (gate opened for CPU tensors, where it runs the
    plain version) under "dots": the flash forward runs twice a layer (it is
    no product, so it is recomputed, as in JAX) and the gradients are the
    no-remat ones."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import attention, flash_cuda

    for module in (attention, llama):
        monkeypatch.setattr(module, "flash_attention_available", lambda q: True)
    calls = []
    original = flash_cuda.flash_fwd
    monkeypatch.setattr(flash_cuda, "flash_fwd", lambda *a, **k: calls.append(1) or original(*a, **k))
    grads = {}
    for remat in (False, True):
        calls.clear()
        grads[remat], _ = backward_mm_count(PipelinedLlamaForCausalLM, remat, "dots")
        assert len(calls) == (4 if remat else 2)  # 2 layers
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, atol=1e-6, rtol=0)


def test_dots_remat_runs_no_dispatch_mode(monkeypatch):
    """The projections' outputs are kept by hand: no Python dispatch mode
    is active in the forward or in the recompute, and every product the
    forward kept is taken back once."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from accelerate_tpu_torch.models import llama

    modes, kept = [], []
    product = llama._KeptProducts.product

    def spy(self, compute):
        modes.append(len(_get_current_dispatch_mode_stack()))
        kept.append(self)
        return product(self, compute)

    monkeypatch.setattr(llama._KeptProducts, "product", spy)
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy="dots"),
                                      device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.stack([r["input_ids"] for r in token_rows(2)])).long()
    causal_lm_loss(model)(dict(model.named_parameters()), {"input_ids": ids}).backward()
    layers = model.config.num_hidden_layers
    assert len(modes) == 2 * 7 * layers and not any(modes)  # 7 projections, forward + recompute
    for store in set(kept):
        assert store.taken == len(store.outputs) == 7
        assert all(out is None for out in store.outputs)  # released as the recompute took them


def test_dots_remat_refuses_a_second_recompute():
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy="dots"),
                                      device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.stack([r["input_ids"] for r in token_rows(2)])).long()
    loss = causal_lm_loss(model)(dict(model.named_parameters()), {"input_ids": ids})
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="recomputed twice"):
        loss.backward()


@pytest.mark.parametrize("cls", [PipelinedLlamaForCausalLM, LlamaForCausalLM],
                         ids=["stacked", "sequential"])
def test_everything_remat_recomputes_nothing(cls):
    plain, plain_mm = backward_mm_count(cls, False, "everything")
    everything, everything_mm = backward_mm_count(cls, True, "everything")
    assert everything_mm == plain_mm
    for name, g in plain.items():
        torch.testing.assert_close(everything[name], g, atol=0, rtol=0)
