"""The port's Llama against the JAX package's, on the CPU at fp32.

Weights are made by the JAX package's own init, perturbed from a numpy seed
(so biases and norm scales are not trivially 0/1), and cross into the port
through ``utils/convert.py``. Logits must agree within atol/rtol 1e-4: both
sides run the einsum attention path in f32, and the remaining differences
are summation order and transcendental rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
from accelerate_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
    init_kv_cache,
)
from accelerate_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)

GEMMA2_STYLE = dict(
    num_attention_heads=4, num_key_value_heads=2, head_dim_override=24,
    layer_windows=(8, None), attn_logit_softcapping=5.0, final_logit_softcapping=3.0,
    post_norms=True, rms_norm_unit_offset=True, scale_embeddings=True,
    mlp_activation="gelu_tanh", query_pre_attn_scalar=20.0, tie_word_embeddings=True,
    rms_norm_eps=1e-6,
)
QWEN2_STYLE = dict(
    attention_qkv_bias=True, rope_theta=10000.0, rms_norm_eps=1e-6,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
)
CONFIGS = {
    "tiny": {},
    "gemma2-style": GEMMA2_STYLE,
    "qwen2-style": QWEN2_STYLE,
    "mistral-style-linear-rope": dict(sliding_window=6, rope_scaling={"rope_type": "linear",
                                                                       "factor": 2.0}),
}


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def jax_sequential(overrides, seed=0):
    cfg = JaxLlamaConfig.tiny(**overrides)
    module = JaxLlamaForCausalLM(cfg)
    params = perturbed(module.init_params(jax.random.PRNGKey(seed)), seed)
    return cfg, module, params


def port_model(cls, overrides, params):
    cfg = LlamaConfig.tiny(**overrides)
    model = cls(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return model.eval()


def ids_for(B, S, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(name):
    overrides = CONFIGS[name]
    _, module, params = jax_sequential(overrides)
    ids = ids_for(2, 32)
    ref = module.apply({"params": params}, jnp.asarray(ids))
    model = port_model(LlamaForCausalLM, overrides, params)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    hidden = module.apply({"params": params}, jnp.asarray(ids), return_hidden=True)
    with torch.no_grad():
        out_hidden = model(torch.from_numpy(ids).long(), return_hidden=True)
    np.testing.assert_allclose(out_hidden.numpy(), np.asarray(hidden), **TOL)


def test_packed_segments_match_jax():
    _, module, params = jax_sequential({})
    ids = ids_for(2, 32)
    segs = np.repeat(np.array([[1] * 12 + [2] * 20]), 2, axis=0).astype(np.int32)
    pos = np.concatenate([np.arange(12), np.arange(20)])[None].repeat(2, 0).astype(np.int32)
    ref = module.apply({"params": params}, jnp.asarray(ids), positions=jnp.asarray(pos),
                       segment_ids=jnp.asarray(segs))
    model = port_model(LlamaForCausalLM, {}, params)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), positions=torch.from_numpy(pos).long(),
                    segment_ids=torch.from_numpy(segs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["tiny", "qwen2-style"])
def test_stacked_layout_matches_jax_pipelined(name):
    overrides = CONFIGS[name]
    cfg = JaxLlamaConfig.tiny(**overrides)
    jmodel = JaxPipelined(cfg)
    params = perturbed(jmodel.init_params(jax.random.PRNGKey(3)), 3)
    ids = ids_for(2, 16)
    ref = jmodel.apply({"params": params}, jnp.asarray(ids))
    model = port_model(PipelinedLlamaForCausalLM, overrides, params)
    assert model.state_dict()["model.blocks.self_attn.q_proj.weight"].shape[0] == 2
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_layout_conversion_matches_jax_and_keeps_logits():
    """Port state dicts convert between the layouts as the JAX
    ``from_/to_sequential_params`` convert flax trees, and both port models
    give the same logits."""
    overrides = CONFIGS["qwen2-style"]
    _, module, params = jax_sequential(overrides, seed=8)
    cfg = LlamaConfig.tiny(**overrides)
    seq_state = state_dict_from_flax(params, cfg)
    stacked_state = PipelinedLlamaForCausalLM.from_sequential_params(seq_state)
    ref_state = state_dict_from_flax(JaxPipelined.from_sequential_params(params), cfg)
    assert stacked_state.keys() == ref_state.keys()
    for name, tensor in ref_state.items():
        assert torch.equal(stacked_state[name], tensor), name
    back = PipelinedLlamaForCausalLM.to_sequential_params(stacked_state)
    assert back.keys() == seq_state.keys()
    assert all(torch.equal(back[k], v) for k, v in seq_state.items())
    stacked = PipelinedLlamaForCausalLM(cfg, device="cpu")
    stacked.load_state_dict(stacked_state)
    ids = torch.from_numpy(ids_for(2, 16)).long()
    with torch.no_grad():
        np.testing.assert_allclose(stacked(ids).numpy(),
                                   port_model(LlamaForCausalLM, overrides, params)(ids).numpy(),
                                   atol=1e-5, rtol=1e-5)


def _assert_same_tree(a, b):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


# The stacked layout needs uniform windows (as in JAX), so no gemma2-style.
@pytest.mark.parametrize("layout,name", [
    ("sequential", "tiny"), ("sequential", "gemma2-style"), ("sequential", "qwen2-style"),
    ("stacked", "tiny"), ("stacked", "qwen2-style"),
])
def test_weight_bridge_round_trip(layout, name):
    overrides = CONFIGS[name]
    cfg = LlamaConfig.tiny(**overrides)
    if layout == "sequential":
        _, _, params = jax_sequential(overrides, seed=4)
        cls = LlamaForCausalLM
    else:
        params = perturbed(JaxPipelined(JaxLlamaConfig.tiny(**overrides)).init_params(
            jax.random.PRNGKey(4)), 4)
        cls = PipelinedLlamaForCausalLM
    state = state_dict_from_flax(params, cfg)
    # Every port parameter is covered, with the port's shapes.
    model = cls(cfg, device="cpu")
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == expected
    _assert_same_tree(flax_from_state_dict(state), params)
    # Dense kernels transpose: flax [in, out] -> torch [out, in].
    prefix = "model.layers.0." if layout == "sequential" else "model.blocks."
    q_kernel = (params["model"]["layers_0"] if layout == "sequential"
                else params["model"]["blocks"])["self_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(state[prefix + "self_attn.q_proj.weight"].numpy(),
                                  np.swapaxes(q_kernel, -1, -2))


def test_weight_bridge_checks_the_config():
    _, _, params = jax_sequential({})
    with pytest.raises(ValueError, match="tie_word_embeddings"):
        state_dict_from_flax(params, LlamaConfig.tiny(tie_word_embeddings=True))
    with pytest.raises(ValueError, match="layers"):
        state_dict_from_flax(params, LlamaConfig.tiny(num_hidden_layers=3))


@pytest.mark.parametrize("name", ["tiny", "gemma2-style", "mistral-style-linear-rope"])
def test_cached_prefill_and_decode_reproduce_uncached_logits(name):
    """Prefill then one-token decodes through the dense and ring caches (the
    windowed layers get rings) give the full forward's logits, and so do
    chunked multi-token writes at a nonzero position."""
    overrides = CONFIGS[name]
    _, module, params = jax_sequential(overrides, seed=5)
    model = port_model(LlamaForCausalLM, overrides, params)
    ids = torch.from_numpy(ids_for(2, 24, seed=6)).long()
    with torch.no_grad():
        full = model(ids)
        ref = module.apply({"params": params}, jnp.asarray(ids.numpy()))
        np.testing.assert_allclose(full.numpy(), np.asarray(ref), **TOL)

        cache = init_kv_cache(model.config, 2, 32, dtype=torch.float32, device="cpu")
        windows = [model.config.window_for(i) for i in range(model.config.num_hidden_layers)]
        assert [("pos" in c) for c in cache] == [w is not None and w < 32 for w in windows]
        logits, cache = model(ids[:, :10], cache=cache, cache_pos=0)
        steps = [logits]
        for t in range(10, 24):
            step, cache = model(ids[:, t:t + 1], cache=cache, cache_pos=t)
            steps.append(step)
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), **TOL)

        cache = init_kv_cache(model.config, 2, 32, dtype=torch.float32, device="cpu")
        chunks = []
        for lo, hi in ((0, 9), (9, 17), (17, 24)):
            out, cache = model(ids[:, lo:hi], cache=cache, cache_pos=lo)
            chunks.append(out)
        np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), full.numpy(), **TOL)


def test_dense_cache_rejects_overflow():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    cache = init_kv_cache(model.config, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        model(torch.zeros((1, 4), dtype=torch.long), cache=cache, cache_pos=6)


def test_context_parallel_backends_are_not_ported():
    """On a cp axis of one process the ring and Ulysses backends are the
    flash path (the JAX package's trivial-axis rule); what they cannot
    take raises as in the JAX package."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16)))
    logits = {}
    for backend in ("auto", "ring", "ulysses"):
        model = LlamaForCausalLM(LlamaConfig.tiny(attention_backend=backend), device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        logits[backend] = model(ids)
    torch.testing.assert_close(logits["ring"], logits["auto"], rtol=0, atol=0)
    torch.testing.assert_close(logits["ulysses"], logits["auto"], rtol=0, atol=0)
    model = LlamaForCausalLM(LlamaConfig.tiny(attention_backend="ring", sliding_window=4),
                             device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="sliding_window"):
        model(ids)
