"""The fp8 training path (``ops/quant.py``) against the JAX package's.

The cases of ``tests/test_fp8.py``, each against the JAX functions on the
same numpy inputs, on the tiny Llama of ``benchmarks/fp8.py`` (hidden 128):

* the arithmetic, bit for bit: ``_quantize``, ``_rolled``, ``_next_scale``;
  ``fp8_matmul``'s output and gradients (the port's plain version, the
  widened product, does the JAX dot's exact fp8 products with f32 sums);
  the JAX ``_bwd``'s meta "cotangents" equal ``next_fp8_meta`` of the
  port's pending amaxes, in every format and amax algorithm;
* the model: every projection's committed statistics after a fused step
  are the JAX arithmetic applied to the operands that step gave it (bit for
  bit); the stacked and sequential layouts cross with ``utils/convert.py``;
  the fused step follows the JAX step's trajectory;
* the update: statistics out of the clip, dropped with a skipped fp16
  step, exact through a checkpoint; "dots" remat and LoRA around them;
* the two reference quirks the port does not copy (ROADMAP.md C): the JAX
  fused step and ``accumulate_grads`` add the microbatches' next
  statistics (the port rolls once with the max of their amaxes), and the
  JAX ``clip_grad_norm_`` scales them (the port's are buffers, untouched);
  and a third, the optax overwrite ``p + (g - p)``, which rounds a scale
  moving from 1 to ~1e-8 to a multiple of 2**-24, so the trajectories start
  from warm statistics (the JAX ``_bwd`` of a warm-up batch);
* dp, FSDP and ZeRO-2 in a gloo world of 2 against the JAX package on 2
  emulated devices.

Tolerances: the arithmetic is bit-exact. A model's statistics from one
set of operands are bit-exact too; two frameworks' forwards differ in the
last bits of f32 sums, and an e4m3 value has 3 mantissa bits, so a flip
at a rounding boundary moves a product by up to 1/8: over 6 steps the
losses agree to 5e-3 relative (measured 2.1e-3), the statistics of the
inputs to 0.1 and of the gradients to 0.3 of their largest entry (measured
0.060 and 0.122); the kernels' (the weights' amaxes) to 1e-3, an AdamW
step of lr 1e-4 taken the other way at the largest weight (measured
6.5e-8 under the bf16 policy, 1.1e-4 in the f32 worlds of 2).
"""

import functools
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import MeshConfig, Model
from accelerate_tpu.data_loader import make_global_batch as jax_make_global_batch
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
from accelerate_tpu.models.llama import fused_causal_lm_loss as jax_fused_loss
from accelerate_tpu.ops import quant as J
from accelerate_tpu.utils.dataclasses import FP8RecipeKwargs as JaxFP8RecipeKwargs
from accelerate_tpu_torch import (
    Accelerator,
    FP8RecipeKwargs,
    GradScalerKwargs,
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
    fused_causal_lm_loss,
    make_global_batch,
    state_dict_from_flax,
)
from accelerate_tpu_torch.ops import quant as P

REPO = Path(__file__).resolve().parents[2]
WORKER = Path(__file__).resolve().parent / "torch_fp8_worker.py"
TIMEOUT = 120
CONFIG = dict(hidden_size=128, intermediate_size=256, use_flash_attention=False, use_fp8=True)
STEPS = 6
LOSS_RTOL = 5e-3
AMAX_RTOL = {"input": 0.1, "kernel": 1e-3, "grad": 0.3}
FORMATS = {"HYBRID": ((J.E4M3, P.E4M3), (J.E5M2, P.E5M2)),
           "E4M3": ((J.E4M3, P.E4M3), (J.E4M3, P.E4M3)),
           "E5M2": ((J.E5M2, P.E5M2), (J.E5M2, P.E5M2))}


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_meta(scales=(1.0, 1.0, 1.0), hist=8, seed=None):
    rng = np.random.default_rng(seed)
    hists = [np.zeros(hist, np.float32) if seed is None
             else np.abs(rng.standard_normal(hist)).astype(np.float32) for _ in range(3)]
    meta = {name: np.float32(s) for name, s in zip(J._META_SCALES, scales)}
    meta.update(dict(zip(J._META_HISTS, hists)))
    return meta


def port_meta(meta):
    out = {k: t(v) for k, v in meta.items()}
    out[P.PENDING] = torch.full((3,), -1.0)
    return out


def same(a, b, what=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True), what


# ---------------------------------------------------------------------------
# The arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_rolled_and_next_scale_are_bit_equal(fmt):
    jd, pd = (J.E4M3, P.E4M3) if fmt == "e4m3" else (J.E5M2, P.E5M2)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 96)) * 7).astype(np.float32)
    x[0, :4] = [1e9, -1e9, 0.0, 1e-30]  # clipped, zero, flushed
    for scale in (1.0, 0.0123, 3.7e-3, 0.0):
        got = P._quantize(t(x), torch.tensor(np.float32(scale)), pd).float().numpy()
        same(got, J._quantize(jnp.asarray(x), jnp.float32(scale), jd).astype(jnp.float32),
             f"quantize at scale {scale}")
    hist = np.abs(rng.standard_normal(16)).astype(np.float32)
    same(P._rolled(t(hist), torch.tensor(3.5)), J._rolled(jnp.asarray(hist), jnp.float32(3.5)))
    for h in (hist, np.zeros(16, np.float32), np.full(16, np.inf, np.float32)):
        for algo in ("max", "most_recent"):
            for margin in (0, 2):
                same(P._next_scale(t(h), torch.tensor(0.5), pd, margin, algo),
                     J._next_scale(jnp.asarray(h), jnp.float32(0.5), jd, margin, algo),
                     f"next scale {algo} margin {margin}")


@pytest.mark.parametrize("recipe", sorted(FORMATS))
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_fp8_matmul_and_its_next_statistics_equal_jax_bit_for_bit(recipe, warm):
    """Forward, dx and dW on the same inputs are bit-identical; the JAX
    ``_bwd``'s meta cotangents (the next statistics) equal
    ``next_fp8_meta`` of the amaxes the port's backward recorded."""
    (jf, pf), (jb, pb) = FORMATS[recipe]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 16, 128)) * 3).astype(np.float32)
    k = (rng.standard_normal((128, 64)) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((4, 16, 64)) * 1e-3).astype(np.float32)
    scales = ((np.abs(x).max() / float(jnp.finfo(jf).max), np.abs(k).max() / 448.0,
               np.abs(dy).max() / float(jnp.finfo(jb).max)) if warm else (1.0, 1.0, 1.0))
    meta = jax_meta(scales, seed=2 if warm else None)
    for algo, margin in (("max", 0), ("most_recent", 1)):
        kw = dict(fwd_dtype=jf, bwd_dtype=jb, margin=margin, amax_compute_algo=algo)
        y, vjp = jax.vjp(lambda a, b, m: J.fp8_matmul(a, b, m, **kw), jnp.asarray(x),
                         jnp.asarray(k), jax.tree_util.tree_map(jnp.asarray, meta))
        dx, dk, dmeta = vjp(jnp.asarray(dy))
        pm = port_meta(meta)
        tx, tk = t(x).requires_grad_(), t(k).requires_grad_()
        py = P.fp8_matmul(tx, tk, pm, fwd_dtype=pf, bwd_dtype=pb)
        py.backward(t(dy))
        same(py.detach(), y, "y")
        same(tx.grad, dx, "dx")
        same(tk.grad, dk, "dk")
        nxt = P.next_fp8_meta(pm, pm[P.PENDING], fwd_dtype=pf, bwd_dtype=pb, margin=margin,
                              amax_compute_algo=algo)
        for name in P.FP8_META_NAMES:
            same(nxt[name], dmeta[name], f"{recipe} {algo} {name}")


def test_fp8_matmul_is_close_to_the_exact_product():
    """``tests/test_fp8.py``'s bounds: e4m3 keeps ~2 digits forward, e5m2
    ~1 backward, so the directions agree strongly."""
    rng = np.random.default_rng(0)
    x, k = t(rng.standard_normal((16, 32))), t(rng.standard_normal((32, 8)))
    np.testing.assert_allclose(P.fp8_matmul(x, k, port_meta(jax_meta())).numpy(),
                               (x @ k).numpy(), atol=0.5, rtol=0.2)
    grads = []
    for fn in (lambda a, b: P.fp8_matmul(a, b, port_meta(jax_meta())), torch.matmul):
        a, b = x.clone().requires_grad_(), k.clone().requires_grad_()
        ((fn(a, b) ** 2).sum() / 100).backward()
        grads.append((a.grad.reshape(-1), b.grad.reshape(-1)))
    for g8, g in zip(*grads):
        assert torch.nn.functional.cosine_similarity(g8, g, dim=0) > 0.99


def test_delayed_scaling_uses_the_previous_scale():
    """Quantization takes the scale it is given: at scale 1, 1000 clips to
    e4m3's 448, so the fresh amax did not feed this product."""
    y = P.fp8_matmul(torch.full((2, 4), 1000.0), torch.ones((4, 2)), port_meta(jax_meta()))
    assert float(y.max()) == pytest.approx(448 * 4, rel=0.01)


def test_the_reference_overwrite_rounds_a_cold_scale_and_the_port_commits_it_exactly():
    """The JAX optimizer applies a statistic as ``p + (g - p)``: from the
    initial scale 1 a gradient scale of ~3e-8 (an amax of 2e-3 over e5m2's
    57344) lands on a multiple of 2**-24 (here 0). The port copies ``g``."""
    g = np.float32(0.0018015 / 57344.0)
    tx = J.overwrite_with_cotangent()
    params = {"grad_scale": jnp.float32(1.0)}
    updates, _ = tx.update({"grad_scale": jnp.float32(g)}, tx.init(params), params)
    applied = float(optax.apply_updates(params, updates)["grad_scale"])
    assert applied != g and applied % 2.0 ** -24 == 0
    dense = P.Fp8Dense(8, 8)
    dense.amax_pending.copy_(torch.tensor([1.0, 1.0, 0.0018015]))
    P.commit_fp8_meta(dense)
    assert dense.grad_scale.item() == np.float32(0.0018015) / np.float32(57344.0)


# ---------------------------------------------------------------------------
# The module and the policy
# ---------------------------------------------------------------------------

def test_fp8_dense_trains_and_its_statistics_move():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 16), generator=gen)
    dense = P.Fp8Dense(16, 4, amax_history_len=4)
    assert P.has_fp8_meta(dense) and not P.has_fp8_meta(torch.nn.Linear(2, 2))
    mask = P.fp8_meta_mask(dense)
    assert mask["weight"] is False and all(mask[n] for n in P.FP8_META_NAMES)
    assert set(dict(dense.named_parameters())) == {"weight"}  # no optimizer sees a statistic
    opt = P.wrap_optimizer_for_fp8(torch.optim.Adam(dense.parameters(), lr=1e-2), dense)
    assert P.fp8_models_of(opt) == [dense]

    def loss():
        return (dense(x) ** 2).mean()

    l0 = loss().item()
    for _ in range(5):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert loss().item() < l0
    amax = x.abs().max().item()
    assert dense.input_amax_history[0].item() == amax
    assert dense.input_scale.item() == pytest.approx(amax / 448.0, rel=1e-6)
    with pytest.raises(ValueError, match="statistic"):
        P.wrap_optimizer_for_fp8(torch.optim.SGD([dense.input_scale], lr=1.0), dense)


def test_the_policy_and_every_cast_keep_the_statistics_f32():
    """``mixed_precision="fp8"`` is the bf16 policy (``policy_for``); the
    module casts, ``cast_to_compute`` of a module and of a state dict, and a
    bf16 forward and backward leave the statistics f32, as the JAX
    ``_cast_floating`` does."""
    import warnings

    from accelerate_tpu.precision import policy_for as jax_policy_for
    from accelerate_tpu_torch import policy_for

    pol = policy_for("fp8")
    ref = jax_policy_for("fp8")
    assert str(pol.compute_dtype).endswith(jnp.dtype(ref.compute_dtype).name)
    model = LlamaForCausalLM(LlamaConfig.tiny(**CONFIG), device="cpu")
    pol.cast_to_compute(model)
    dtypes = {n.rsplit(".", 1)[-1]: b.dtype for n, b in model.named_buffers()}
    assert set(dtypes.values()) == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    model.half()
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    cast = pol.cast_to_compute(model.state_dict())
    for name, tensor in cast.items():
        want = torch.float32 if name.rsplit(".", 1)[-1] in P.FP8_META_NAMES else torch.bfloat16
        assert tensor.dtype == want, name
    model.to(torch.bfloat16)
    ids = torch.randint(0, 256, (2, 8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model(ids).float().sum().backward()
    assert {b.dtype for b in model.buffers()} == {torch.float32}


def test_recipe_kwargs_and_config_bridge_match_jax():
    ours, ref = FP8RecipeKwargs(), JaxFP8RecipeKwargs()
    assert ours.to_kwargs() == {} and vars(ours) == vars(ref)
    recipe = FP8RecipeKwargs(margin=2, amax_history_len=32, fp8_format="E4M3")
    kwargs = P.recipe_to_config_kwargs(recipe)
    assert kwargs == J.recipe_to_config_kwargs(JaxFP8RecipeKwargs(
        margin=2, amax_history_len=32, fp8_format="E4M3"))
    cfg = LlamaConfig.tiny(**kwargs)
    assert cfg.use_fp8 and cfg.fp8_margin == 2 and cfg.fp8_format == "E4M3"
    proj = LlamaForCausalLM(cfg, device="cpu").model.layers[0].self_attn.q_proj
    assert (proj.fwd_dtype, proj.bwd_dtype, proj.margin) == (P.E4M3, P.E4M3, 2)
    assert proj.input_amax_history.shape == (32,)


@pytest.mark.parametrize("stacked", [False, True], ids=["sequential", "stacked"])
def test_the_fp8_projections_and_their_statistics_cross_from_flax(stacked):
    """The seven projections of every layer are ``Fp8Dense`` (formats by
    ``fp8_format``), the embedding and the head are not; the JAX leaves
    load by name (the stacked ones ``[L]`` and ``[L, history]``) and the
    forwards agree."""
    jcfg = JaxLlamaConfig.tiny(**CONFIG, fp8_format="E5M2")
    cfg = LlamaConfig.tiny(**CONFIG, fp8_format="E5M2")
    jmodel = (JaxPipelined if stacked else JaxLlama)(jcfg)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0), batch_size=1, seq_len=8))
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: np.asarray(p) * (1.5 if path[-1].key == "input_scale" else 1.0), params)
    model = (PipelinedLlamaForCausalLM if stacked else LlamaForCausalLM)(cfg, device="cpu")
    state = state_dict_from_flax(params, cfg)
    model.load_state_dict(state)  # strict: every leaf and buffer by name
    fp8 = [n for n, m in model.named_modules() if isinstance(m, P.Fp8Dense)]
    assert len(fp8) == 7 * (1 if stacked else cfg.num_hidden_layers)
    assert all(m.fwd_dtype == P.E5M2 and m.bwd_dtype == P.E5M2
               for m in model.modules() if isinstance(m, P.Fp8Dense))
    assert not isinstance(model.lm_head, P.Fp8Dense)
    scale = dict(model.named_buffers())[
        "model.blocks.self_attn.q_proj.input_scale" if stacked
        else "model.layers.1.self_attn.q_proj.input_scale"]
    assert scale.shape == ((cfg.num_hidden_layers,) if stacked else ())
    assert torch.all(scale == 1.5)
    ids = np.random.default_rng(0).integers(0, 256, (2, 8))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    got = model(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def warm_params():
    """JAX params whose statistics are warm: each is the JAX ``_bwd``'s value
    after a warm-up batch (so the reference's ``p + (g - p)`` overwrite is
    accurate from the first step). Shared by the tests of a process: read,
    never written."""
    module = JaxPipelined(JaxLlamaConfig.tiny(**CONFIG))
    params = jax.device_get(module.init_params(jax.random.PRNGKey(42), batch_size=2, seq_len=32))
    warm = {"input_ids": np.random.default_rng(7).integers(0, 256, (8, 32)).astype(np.int32)}
    grads = jax.grad(lambda p: jax_fused_loss(module)(p, warm))(params)
    return jax.device_get(jax.tree_util.tree_map_with_path(
        lambda path, p, g: np.asarray(g) if path[-1].key in J.FP8_META_NAMES else np.asarray(p),
        params, grads))


def batches(n=STEPS, accum=None, seed=42):
    rng = np.random.default_rng(seed)
    shape = (8, 32) if accum is None else (accum, 4, 32)
    return [{"input_ids": rng.integers(0, 256, shape).astype(np.int32)} for _ in range(n)]


def stats(state: dict) -> dict:
    return {k: np.array(v, np.float32, copy=True) for k, v in state.items()
            if k.rsplit(".", 1)[-1] in P.FP8_META_NAMES}


def jax_run(params, data, precision="fp8", accum=None, mesh_config=None, **plugins):
    module = JaxPipelined(JaxLlamaConfig.tiny(**CONFIG))
    acc = JaxAccelerator(mixed_precision=precision, mesh_config=mesh_config, **plugins)
    model, _ = acc.prepare(Model(module, params), optax.adamw(1e-4))
    step = acc.compile_train_step(jax_fused_loss(module), max_grad_norm=1.0,
                                  accumulation_steps=accum)
    losses, states = [], []
    for b in data:
        with acc.mesh:
            losses.append(float(step(jax_make_global_batch(b, acc.mesh))["loss"]))
        states.append(stats(state_dict_from_flax(jax.device_get(model.params),
                                                 LlamaConfig.tiny(**CONFIG))))
    return losses, states


def port_setup(params, precision="fp8", max_grad_norm=1.0, accum=None, **kwargs):
    """The stacked port model from JAX ``params`` (None: seeded random
    weights and cold statistics, for the tests that need no JAX run),
    prepared, with its fused step."""
    cfg = LlamaConfig.tiny(**CONFIG)
    if params is None:
        model = PipelinedLlamaForCausalLM(cfg, device="cpu",
                                          generator=torch.Generator().manual_seed(5))
    else:
        model = PipelinedLlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(state_dict_from_flax(params, cfg))
    acc = Accelerator(mixed_precision=precision, cpu=True, **kwargs)
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=max_grad_norm,
                                  accumulation_steps=accum)
    return acc, model, opt, step


def close_stats(got: dict, want: dict, what: str):
    assert got.keys() == want.keys()
    for name, ref in want.items():
        kind = name.rsplit(".", 1)[-1].split("_")[0]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got[name] - ref).max())
        assert err <= AMAX_RTOL[kind] * scale, (what, name, err, scale)


def test_fused_step_follows_the_jax_trajectory():
    """Six fused steps of the stacked Llama under ``mixed_precision="fp8"``
    from the same warm weights: the losses and every statistic follow the
    JAX step (tolerances in the module docstring)."""
    params = warm_params()
    data = batches()
    ref_losses, ref_states = jax_run(params, data)
    acc, model, _, step = port_setup(params)
    for i, b in enumerate(data):
        loss = step(make_global_batch(b, acc))["loss"].item()
        np.testing.assert_allclose(loss, ref_losses[i], rtol=LOSS_RTOL, err_msg=f"step {i}")
        close_stats(stats(model.module.state_dict()), ref_states[i], f"step {i}")
    assert ref_losses[-1] != ref_losses[0]


def test_committed_statistics_are_the_jax_arithmetic_of_the_step_operands():
    """Every projection of the sequential Llama records the x, W and dy of
    its one product in a fused bf16 step (the second: the statistics warm);
    its committed statistics equal the JAX ``_rolled`` and ``_next_scale``
    of those operands' ``_amax``, bit for bit."""
    cfg = LlamaConfig.tiny(**CONFIG)
    model = LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    data = [make_global_batch(b, acc) for b in batches(2)]
    step(data[0])
    before = stats(model.module.state_dict())
    seen = {}
    modules = {n: m for n, m in model.module.named_modules() if isinstance(m, P.Fp8Dense)}

    def hook(name):
        def fn(mod, args, out):
            seen[name] = {"x": args[0].detach().clone(), "w": mod.weight.detach().clone()}
            out.register_hook(lambda g: seen[name].__setitem__("dy", g.detach().clone()))
        return fn

    for name, m in modules.items():
        m.register_forward_hook(hook(name))
    step(data[1])
    after = stats(model.module.state_dict())
    assert len(seen) == 7 * cfg.num_hidden_layers
    for name, ops in seen.items():
        assert ops["x"].dtype == ops["w"].dtype == ops["dy"].dtype == torch.bfloat16
        for kind, tensor, fmt in (("input", ops["x"], J.E4M3), ("kernel", ops["w"], J.E4M3),
                                  ("grad", ops["dy"], J.E5M2)):
            hist = J._rolled(jnp.asarray(before[f"{name}.{kind}_amax_history"]),
                             J._amax(jnp.asarray(tensor.float().numpy())))
            scale = J._next_scale(hist, jnp.asarray(before[f"{name}.{kind}_scale"]), fmt, 0,
                                  "max")
            same(after[f"{name}.{kind}_amax_history"], hist, f"{name} {kind} history")
            same(after[f"{name}.{kind}_scale"], scale, f"{name} {kind} scale")


def test_accumulation_the_reference_sums_the_port_takes_the_max():
    """At ``gradient_accumulation_steps=2`` the JAX fused step's scan adds
    every gradient leaf, so each statistic is the sum of the two
    microbatches' ``_bwd`` values (the history's old slots doubled). The
    port rolls the history once with the max of the two amaxes it
    recorded; at accumulation 1 the two agree (the trajectory test)."""
    params = warm_params()
    data = batches(1, accum=2)
    _, (ref,) = jax_run(params, data, precision="no", accum=2)
    module = JaxPipelined(JaxLlamaConfig.tiny(**CONFIG))
    # Each microbatch's _bwd values, of the loss divided by the
    # accumulation count, as both steps differentiate it.
    grad = jax.jit(jax.grad(lambda p, ids: jax_fused_loss(module)(p, {"input_ids": ids}) / 2))
    per_micro = [stats(state_dict_from_flax(jax.device_get(grad(params, data[0]["input_ids"][i])),
                                            LlamaConfig.tiny(**CONFIG))) for i in range(2)]
    start = stats(state_dict_from_flax(params, LlamaConfig.tiny(**CONFIG)))
    for name, value in ref.items():
        np.testing.assert_allclose(value, per_micro[0][name] + per_micro[1][name], rtol=1e-5,
                                   atol=1e-12, err_msg=name)
        if name.endswith("_history"):  # the old slots, doubled
            np.testing.assert_allclose(value[..., 2:], 2 * start[name][..., 1:-1], rtol=1e-6)

    acc, model, _, step = port_setup(params, precision="no", accum=2)
    recorded = []
    real = P.commit_fp8_meta

    def commit(m):
        recorded.append({n: mod.amax_pending.clone() for n, mod in m.named_modules()
                         if isinstance(mod, P.Fp8Dense)})
        real(m)

    P.commit_fp8_meta = commit
    try:
        step(make_global_batch(data[0], acc))
    finally:
        P.commit_fp8_meta = real
    assert len(recorded) == 1  # one commit for the two microbatches
    got = stats(model.module.state_dict())
    for name, pending in recorded[0].items():
        for i, kind in enumerate(("input", "kernel", "grad")):
            hist = got[f"{name}.{kind}_amax_history"]
            same(hist[..., 0], pending[..., i], f"{name} {kind}")
            same(hist[..., 1:], start[f"{name}.{kind}_amax_history"][..., :-1])
            # The max of the microbatches' amaxes, which JAX's _bwd recorded
            # one by one (another framework's forward and backward: within the
            # trajectory test's input tolerance).
            want = np.maximum(per_micro[0][f"{name}.{kind}_amax_history"][..., 0],
                              per_micro[1][f"{name}.{kind}_amax_history"][..., 0])
            np.testing.assert_allclose(hist[..., 0], want, rtol=AMAX_RTOL["input"])


def test_clip_the_reference_loop_scales_the_statistics_the_port_leaves_them():
    """The JAX ``Accelerator.clip_grad_norm_`` has no fp8 mask: in the
    user's loop it scales the statistics' "gradients" with the rest, so a
    tight clip shrinks them. The port's statistics are buffers: its loop's
    clip and the fused step's leave them as the unclipped commit makes
    them, bit for bit."""
    params = warm_params()
    b = batches(1)[0]
    module = JaxPipelined(JaxLlamaConfig.tiny(**CONFIG))
    acc = JaxAccelerator(mixed_precision="no")
    model, opt = acc.prepare(Model(module, params), optax.adamw(1e-4))
    acc.backward(jax_fused_loss(module), jax_make_global_batch(b, acc.mesh))
    true_next = stats(state_dict_from_flax(jax.device_get(opt.acc_grads),
                                           LlamaConfig.tiny(**CONFIG)))
    gnorm = float(acc.clip_grad_norm_(max_norm=1e-3))
    opt.step()
    clipped = stats(state_dict_from_flax(jax.device_get(model.params), LlamaConfig.tiny(**CONFIG)))
    factor = 1e-3 / (gnorm + 1e-6)
    scale = "model.blocks.self_attn.q_proj.input_scale"
    # Up to the overwrite's rounding, p + (g - p): a few ulps of the old
    # scale p (~8e-3), ~1e-9.
    np.testing.assert_allclose(clipped[scale], true_next[scale] * factor, rtol=1e-4, atol=1e-8)
    assert np.all(clipped[scale] < 1e-2 * true_next[scale])

    results = []
    for fused in (False, True):
        for max_norm in (1e-3, None):
            from accelerate_tpu_torch.state import AcceleratorState, GradientState

            AcceleratorState._reset_state(reset_partial_state=True)
            GradientState._reset_state()
            pacc, pmodel, popt, step = port_setup(params, precision="no", max_grad_norm=max_norm)
            batch = make_global_batch(b, pacc)
            if fused:
                step(batch)
            else:
                pacc.backward(fused_causal_lm_loss(pmodel), batch)
                if max_norm is not None:
                    pacc.clip_grad_norm_(max_norm=max_norm)
                popt.step()
            results.append(stats(pmodel.module.state_dict()))
    for got in results[1:]:
        for name, value in results[0].items():
            same(got[name], value, name)
    # The port's statistics are the unclipped next ones (another framework's
    # step: the input amaxes' tolerance of the trajectory test).
    np.testing.assert_allclose(results[0][scale], true_next[scale], rtol=AMAX_RTOL["input"])


def test_a_skipped_fp16_step_drops_the_statistics():
    acc, model, opt, step = port_setup(None, precision="fp16",
                                       kwargs_handlers=[GradScalerKwargs(init_scale=2.0**100)])
    start = stats(model.module.state_dict())
    metrics = step(make_global_batch(batches(1)[0], acc))
    assert not bool(metrics["finite"]) and opt.step_was_skipped
    got = stats(model.module.state_dict())
    for name, value in start.items():
        same(got[name], value, name)
    assert all(bool((m.amax_pending == -1).all()) for m in P.fp8_modules(model))
    # With a loss scale that fits, the step applies and the statistics move.
    opt.loss_scale = opt.loss_scale._replace(scale=torch.tensor(1.0))
    assert bool(step(make_global_batch(batches(1)[0], acc))["finite"])
    assert not np.array_equal(stats(model.module.state_dict())[
        "model.blocks.self_attn.q_proj.input_amax_history"],
        start["model.blocks.self_attn.q_proj.input_amax_history"])


def test_a_checkpoint_round_trip_is_exact(tmp_path):
    from accelerate_tpu_torch.checkpointing import load_safetensors_model, save_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    acc, model, _, step = port_setup(None)
    data = [make_global_batch(b, acc) for b in batches(3)]
    step(data[0])
    acc.save_state(str(tmp_path / "ck"))
    save_model(acc, model, str(tmp_path / "export"))
    saved = stats(model.module.state_dict())
    step(data[1])
    losses = [step(data[2])["loss"].item()]
    exported = load_safetensors_model(str(tmp_path / "export"))
    for name, value in saved.items():
        node = exported
        for part in name.split("."):
            node = node[part]
        same(node, value, name)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc, model, _, step = port_setup(None)
    acc.load_state(str(tmp_path / "ck"))
    got = stats(model.module.state_dict())
    for name, value in saved.items():
        same(got[name], value, name)
    step(data[1])
    assert step(data[2])["loss"].item() == losses[0]


@pytest.mark.parametrize("stacked", [False, True], ids=["sequential", "stacked"])
def test_dots_remat_and_lora_work_around_the_fp8_projections(stacked):
    """"dots" keeps the fp8 products for the recompute: the loss, the
    gradients and the recorded amaxes equal those without remat, and the
    products run 3 a projection either way; a LoRA adapter's delta adds
    around them."""
    from accelerate_tpu_torch.adapters.lora import LoRAConfig, init_lora_params

    cls = PipelinedLlamaForCausalLM if stacked else LlamaForCausalLM
    ids = torch.from_numpy(batches(1)[0]["input_ids"]).long()
    runs = []
    for remat in (False, True):
        cfg = LlamaConfig.tiny(**CONFIG, remat=remat, remat_policy="dots")
        model = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        calls = []
        real = P.fp8_gemm

        def counting(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        P.fp8_gemm = counting
        try:
            loss = fused_causal_lm_loss(model)(dict(model.named_parameters()), {"input_ids": ids})
            loss.backward()
        finally:
            P.fp8_gemm = real
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                     [m.amax_pending.clone() for m in P.fp8_modules(model)], len(calls)))
    (l0, g0, a0, c0), (l1, g1, a1, c1) = runs
    assert l0 == l1 and c0 == c1 == 3 * 7 * cfg.num_hidden_layers
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0)
    for x, y in zip(a0, a1):
        assert torch.equal(x, y)
    if not stacked:
        model = LlamaForCausalLM(LlamaConfig.tiny(**CONFIG), device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        lora = init_lora_params(torch.Generator().manual_seed(4), model, LoRAConfig(rank=4))
        for mod in lora.values():
            mod["b"].normal_(0, 0.1)
        with torch.no_grad():
            assert not torch.equal(model(ids, lora=lora), model(ids))


# ---------------------------------------------------------------------------
# A gloo world of 2
# ---------------------------------------------------------------------------

def launch(out):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
           "--use_cpu_emulation", "--num_processes", "2", str(WORKER), str(out)]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"timed out after {TIMEOUT} s:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]


def test_a_world_of_two_follows_jax_on_two_devices(tmp_path):
    """``benchmarks/fp8.py``'s layouts (dp, FSDP, ZeRO-2) at world 2 over
    gloo, one launch running all three, the JAX package on 2 emulated
    devices the reference (f32 compute, so only the fp8 roundings differ).
    Each commit's statistics are every process's max, bit for bit: both
    processes hold the same statistics, each history's slot 0 the max of
    the two processes' recorded amaxes. A tp plugin of 2 and a pp plugin of
    2 are refused by name."""
    from accelerate_tpu.utils import DeepSpeedPlugin as JaxDeepSpeed
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP

    params = warm_params()
    data = batches(4)
    state = state_dict_from_flax(params, LlamaConfig.tiny(**CONFIG))
    np.savez(tmp_path / "fp8_in.npz", precision="no",
             input_ids=np.stack([b["input_ids"] for b in data]),
             **{f"param.{k}": v.numpy() for k, v in state.items()})
    launch(tmp_path)
    devices = jax.devices()[:2]
    references = {
        "dp": (MeshConfig(dp=2, devices=devices), {}),
        "fsdp": (MeshConfig(fsdp=2, devices=devices),
                 dict(fsdp_plugin=JaxFSDP(min_weight_size_to_shard=1))),
        "zero2": (MeshConfig(fsdp=2, devices=devices),
                  dict(deepspeed_plugin=JaxDeepSpeed(zero_stage=2))),
    }
    from accelerate_tpu.state import AcceleratorState as JaxState
    from accelerate_tpu.state import GradientState as JaxGradientState

    for layout, (mesh, plugins) in references.items():
        JaxState._reset_state()
        JaxGradientState._reset_state()
        ranks = [np.load(tmp_path / f"{layout}_{r}.npz") for r in range(2)]
        ref_losses, ref_states = jax_run(params, data, precision="no", mesh_config=mesh,
                                         **plugins)
        for r, got in enumerate(ranks):
            assert int(got["num_processes"]) == 2
            np.testing.assert_allclose(got["losses"], ref_losses, rtol=LOSS_RTOL,
                                       err_msg=layout)
            close_stats({k[len("stat."):]: got[k] for k in got.files if k.startswith("stat.")},
                        ref_states[-1], f"{layout} rank {r}")
            for k in got.files:
                if k.startswith("stat."):
                    same(got[k], ranks[0][k], k)  # one set of statistics on every process
            # Slot 0 after each commit: the max over the world of the amaxes
            # each process recorded (the inputs' column of [.., 3]).
            local = np.stack([rk["local"] for rk in ranks]).reshape(2, len(data), -1, 3)
            same(got["committed"], local.max(axis=0)[..., 0], layout)
        assert not np.array_equal(ranks[0]["local"], ranks[1]["local"])  # the max mattered
    for r in range(2):
        got = np.load(tmp_path / f"dp_{r}.npz")
        for axis in ("tp", "pp"):
            assert "tp > 1 or pp > 1 are not ported" in str(got[f"refused_{axis}"])
            assert "ROADMAP.md, A10" in str(got[f"refused_{axis}"])
