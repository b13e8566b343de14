"""The port's train step against the JAX package's.

From the same initial weights (the JAX package's init, perturbed from a
numpy seed, crossing through ``utils/convert.py`` in the stacked ``blocks``
layout) and the same numpy batches, the JAX side runs
``Accelerator(...).prepare(Model(PipelinedLlamaForCausalLM(cfg), params),
optax.adamw(1e-4))`` with ``compile_train_step(fused_causal_lm_loss(...),
max_grad_norm=1.0)``, and the port its counterpart with
``torch.optim.AdamW(lr=1e-4, weight_decay=1e-4)``, for 5 steps. ``loss`` and
``grad_norm`` must follow the JAX trajectory at every step and the final
parameters must agree, both as values and as the update each tensor took
(relative L2 of the difference of the two updates). AdamW moves a weight
whose gradient is near its eps (1e-8) by an amount that is sensitive to the
gradient's last digits, so single weights may differ by a fraction of one
step (lr 1e-4) while the loss agrees to 1e-7:

* fp32: relative 1e-4 on loss and grad_norm (both sides do the same f32
  arithmetic in another order; measured <= 3e-7), updates within 5e-3
  (measured <= 6e-4), weights within half a step (5e-5);
* bf16 compute over f32 masters: relative 5e-3 on the loss and 2e-2 on the
  grad norm (measured 8e-4 and 3e-3: the two frameworks round bf16 at other
  places, XLA fusing what torch runs op by op), updates within 0.25
  (measured 0.11: bf16 gradients of weights near eps flip the sign of
  their step), weights within 2e-3.

Also: one AdamW step against optax.adamw on the same arrays, the fp16 loss
scale against the JAX functions, remat against no remat, and the step's
contract (accumulation shapes, what is not ported).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.data_loader import make_global_batch as jax_make_global_batch
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
from accelerate_tpu.models.llama import fused_causal_lm_loss as jax_fused_causal_lm_loss
from accelerate_tpu.precision import LossScaleState as JaxLossScaleState
from accelerate_tpu.precision import update_loss_scale as jax_update_loss_scale
from accelerate_tpu.utils.dataclasses import GradScalerKwargs as JaxGradScalerKwargs
from accelerate_tpu_torch import (
    Accelerator,
    GradScalerKwargs,
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
    fused_causal_lm_loss,
    make_global_batch,
    state_dict_from_flax,
)
from accelerate_tpu_torch.precision import LossScaleState, update_loss_scale

STEPS = 5
FP32 = dict(loss=1e-4, grad_norm=1e-4, update=5e-3, params=5e-5)
BF16 = dict(loss=5e-3, grad_norm=2e-2, update=0.25, params=2e-3)


def initial_params(seed=0):
    jmodel = JaxPipelined(JaxLlamaConfig.tiny())
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        jmodel.init_params(jax.random.PRNGKey(seed)))


def make_batches(accum=None, seed=1):
    rng = np.random.default_rng(seed)
    shape = (2, 16) if accum is None else (accum, 2, 16)
    return [{"input_ids": rng.integers(0, 256, shape).astype(np.int32)} for _ in range(4)]


def jax_trajectory(params, batches, mixed_precision, accum, grad_reduce=False):
    module = JaxPipelined(JaxLlamaConfig.tiny())
    acc = JaxAccelerator(mixed_precision=mixed_precision)
    model, _ = acc.prepare(Model(module, params), optax.adamw(1e-4))
    step = acc.compile_train_step(jax_fused_causal_lm_loss(module), max_grad_norm=1.0,
                                  accumulation_steps=accum,
                                  grad_reduce_dtype=jnp.bfloat16 if grad_reduce else None)
    metrics = [step(jax_make_global_batch(batches[i % 4], acc.mesh)) for i in range(STEPS)]
    history = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
    return history, jax.device_get(model.params)


def port_setup(params, mixed_precision, cfg=None, **step_kwargs):
    cfg = cfg or LlamaConfig.tiny()
    model = PipelinedLlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    acc = Accelerator(mixed_precision=mixed_precision, cpu=True)
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0, **step_kwargs)
    return acc, model, opt, step


def port_trajectory(params, batches, mixed_precision, accum, grad_reduce=False):
    acc, model, _, step = port_setup(params, mixed_precision, accumulation_steps=accum,
                                     grad_reduce_dtype=torch.bfloat16 if grad_reduce else None)
    metrics = [step(make_global_batch(batches[i % 4], acc)) for i in range(STEPS)]
    history = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    return history, model.state_dict()


@pytest.mark.parametrize("mixed_precision,accum,tol,grad_reduce", [
    ("no", None, FP32, False), ("no", 2, FP32, False), ("bf16", None, BF16, False),
    ("bf16", 2, BF16, True),
], ids=["fp32", "fp32-accumulation-2", "bf16", "bf16-grad-reduce-bf16-accumulation-2"])
def test_train_step_follows_the_jax_trajectory(mixed_precision, accum, tol, grad_reduce):
    """grad_reduce: ``grad_reduce_dtype=bf16`` on both sides, the gradients
    taken with respect to the bf16-cast parameters (the JAX package's
    TestGradReduceDtype mechanism), upcast and summed in f32."""
    params = initial_params()
    batches = make_batches(accum)
    ref_history, ref_params = jax_trajectory(params, batches, mixed_precision, accum, grad_reduce)
    history, state = port_trajectory(params, batches, mixed_precision, accum, grad_reduce)
    for i, ((loss, gnorm), (ref_loss, ref_gnorm)) in enumerate(zip(history, ref_history)):
        np.testing.assert_allclose(loss, ref_loss, rtol=tol["loss"], err_msg=f"loss, step {i}")
        np.testing.assert_allclose(gnorm, ref_gnorm, rtol=tol["grad_norm"],
                                   err_msg=f"grad_norm, step {i}")
    assert history[-1][0] != history[0][0]
    initial = state_dict_from_flax(params, LlamaConfig.tiny())
    expected = state_dict_from_flax(ref_params, LlamaConfig.tiny())
    assert expected.keys() == state.keys()
    for name, tensor in expected.items():
        np.testing.assert_allclose(state[name].numpy(), tensor.numpy(), atol=tol["params"],
                                   rtol=0, err_msg=name)
        update, ref_update = state[name] - initial[name], tensor - initial[name]
        rel = ((update - ref_update).norm() / ref_update.norm()).item()
        assert rel <= tol["update"], (name, rel)


def test_adamw_step_matches_optax_adamw():
    """torch.optim.AdamW(lr=1e-4, weight_decay=1e-4) is optax.adamw(1e-4):
    b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, decoupled decay on every
    parameter, bias correction. Two steps on the same arrays."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    grads = [rng.standard_normal((8, 5)).astype(np.float32) for _ in range(2)]
    tx = optax.adamw(1e-4)
    jw, state = jnp.asarray(w), tx.init(jnp.asarray(w))
    tw = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt = torch.optim.AdamW([tw], lr=1e-4, weight_decay=1e-4)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, updates)
        tw.grad = torch.from_numpy(g)
        opt.step()
    # Within one f32 ulp of the weights (|w| < 4): a thousandth of one step.
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), atol=2.4e-7, rtol=0)
    assert np.abs(np.asarray(jw) - w).min() > 1e-5  # and the weights did move


@pytest.mark.parametrize("history", [
    [True, True, True], [True, False, True, True], [False, False], [True] * 5,
], ids=["grow", "backoff-resets", "backoff-twice", "grow-twice"])
def test_loss_scale_update_matches_jax(history):
    kwargs = dict(init_scale=1024.0, growth_factor=2.0, backoff_factor=0.5, growth_interval=2)
    jstate = JaxLossScaleState(jnp.asarray(1024.0, jnp.float32), jnp.zeros((), jnp.int32),
                               jnp.zeros((), jnp.int32))
    state = LossScaleState(torch.tensor(1024.0), torch.zeros((), dtype=torch.int32),
                           torch.zeros((), dtype=torch.int32))
    for finite in history:
        jstate = jax_update_loss_scale(jstate, jnp.asarray(finite), JaxGradScalerKwargs(**kwargs))
        state = update_loss_scale(state, torch.tensor(finite), GradScalerKwargs(**kwargs))
        for ours, ref in zip(state, jstate):
            assert ours.item() == ref.item()


def test_fp16_step_skips_a_non_finite_update():
    acc, model, opt, step = port_setup(initial_params(), "fp16")
    assert opt.loss_scale.scale.item() == 65536.0
    batch = make_global_batch(make_batches()[0], acc)
    metrics = step(batch)
    assert metrics["finite"].item() and torch.isfinite(metrics["loss"])
    assert opt.steps_applied == 1 and not opt.step_was_skipped
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    adam_state = [s["exp_avg"].clone() for s in opt.optimizer.state.values()]
    # An inf in the embedding makes every gradient of the step non-finite.
    with torch.no_grad():
        model.module.model.embed_tokens.weight[batch["input_ids"][0, 0]] = float("inf")
    before["model.embed_tokens.weight"] = model.module.model.embed_tokens.weight.detach().clone()
    metrics = step(batch)
    assert not metrics["finite"].item()
    assert metrics["loss_scale"].item() == 32768.0
    assert opt.step_was_skipped and opt.steps_applied == 1
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), before[name]), name
    for ref, s in zip(adam_state, opt.optimizer.state.values()):
        assert torch.equal(s["exp_avg"], ref)


@pytest.mark.parametrize("cls", [PipelinedLlamaForCausalLM, LlamaForCausalLM],
                         ids=["stacked", "sequential"])
def test_remat_gives_the_same_gradients(cls):
    """remat=True (torch.utils.checkpoint per layer) recomputes the same
    f32 arithmetic: the gradients are bit-identical, also through the
    loss factories' functional_call with bf16-cast parameters."""
    batch = {"input_ids": torch.from_numpy(make_batches()[0]["input_ids"]).long()}
    grads = {}
    for remat in (False, True):
        model = cls(LlamaConfig.tiny(remat=remat), device="cpu",
                    generator=torch.Generator().manual_seed(0))
        for dtype in (torch.float32, torch.bfloat16):
            model.zero_grad()
            params = {n: p.to(dtype) for n, p in model.named_parameters()}
            causal_lm_loss(model)(params, batch).backward()
            grads[remat, dtype] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for dtype in (torch.float32, torch.bfloat16):
        for name, g in grads[False, dtype].items():
            assert torch.equal(grads[True, dtype][name], g), (dtype, name)


def test_optimizer_state_dict_round_trip():
    """The wrapper's state (torch optimizer state, applied steps, loss scale)
    restores into a fresh one, and both then take the same next step."""
    params = initial_params()
    batch = make_batches()[0]
    acc, model, opt, step = port_setup(params, "fp16")
    for _ in range(2):
        step(make_global_batch(batch, acc))
    sd = opt.state_dict()
    acc2, model2, opt2, step2 = port_setup(params, "fp16")
    model2.module.load_state_dict(model.state_dict())
    opt2.load_state_dict(sd)
    assert opt2.steps_applied == opt.steps_applied == 2
    assert all(torch.equal(a, b) for a, b in zip(opt2.loss_scale, opt.loss_scale))
    step(make_global_batch(batch, acc))
    step2(make_global_batch(batch, acc2))
    for (name, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b), name


def test_prepared_model_runs_in_the_compute_dtype():
    """Calling the prepared model casts the f32 masters to the compute dtype
    for the forward and returns f32, as JAX's AcceleratedModel does."""
    acc, model, _, _ = port_setup(initial_params(), "bf16")
    ids = torch.from_numpy(make_batches()[0]["input_ids"]).long()
    with torch.no_grad():
        logits = model(ids)
        ref = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu", dtype=torch.bfloat16)
        ref.load_state_dict(model.state_dict())
        expected = ref(ids)
    assert logits.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    torch.testing.assert_close(logits, expected.float(), atol=0, rtol=0)


def test_accumulation_needs_a_microbatch_dim():
    acc, _, _, step = port_setup(initial_params(), "no", accumulation_steps=3)
    with pytest.raises(ValueError, match="leading microbatch dim of 3"):
        step(make_global_batch(make_batches()[0], acc))


def test_grad_reduce_dtype_sees_narrow_params_and_warns_on_a_mismatch():
    seen, grad_dtypes = [], set()
    acc, model, opt, _ = port_setup(initial_params(), "no")
    loss_fn = fused_causal_lm_loss(model)

    def spy(params, batch):
        seen.append(params["lm_head.weight"].dtype)
        return loss_fn(params, batch)

    # The update consumes the gradients, so their dtype is read as it starts.
    opt.optimizer.register_step_pre_hook(
        lambda *_: grad_dtypes.update(p.grad.dtype for p in model.parameters()))
    with pytest.warns(UserWarning, match="grad_reduce_dtype"):
        step = acc.compile_train_step(spy, grad_reduce_dtype=torch.bfloat16)
    metrics = step(make_global_batch(make_batches()[0], acc))
    assert seen == [torch.bfloat16] and torch.isfinite(metrics["loss"])
    assert grad_dtypes == {torch.float32}


def test_unported_options_raise():
    """HYBRID_SHARD and meshes are ported, the expert-parallel axis too:
    ``ep=2`` over one process fails as any axis that does not divide it."""
    from accelerate_tpu_torch import FullyShardedDataParallelPlugin, MeshConfig

    acc = Accelerator(cpu=True,
                      fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="HYBRID_SHARD"))
    assert acc.fsdp_plugin.sharding_strategy == "HYBRID_SHARD"
    assert acc.mesh.shape == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "cp": 1, "tp": 1}
    with pytest.raises(ValueError, match="not divisible"):
        MeshConfig(ep=2).build()


def test_make_global_batch_types_and_device():
    acc = Accelerator(cpu=True)
    batch = make_global_batch({"input_ids": np.arange(6, dtype=np.int32).reshape(2, 3),
                               "weights": np.ones(2, np.float64),
                               "nested": [np.zeros(2, bool)]}, acc)
    assert batch["input_ids"].dtype == torch.int64 and batch["input_ids"].device.type == "cpu"
    assert batch["weights"].dtype == torch.float32
    assert batch["nested"][0].dtype == torch.bool
    assert make_global_batch({"x": np.zeros(1)}, "cpu")["x"].device.type == "cpu"
