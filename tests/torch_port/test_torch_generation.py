"""The port's KV-cached generate against the JAX package's, on the CPU.

Greedy decoding is token-exact against ``accelerate_tpu.generation.generate``
on the same weights at fp32 (f32 KV cache). Sampled tokens are not compared
with JAX (threefry and Philox differ): the warper is held to JAX's on the
same logits, and sampling to determinism under a seeded generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import _make_warper as jax_make_warper
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu_torch import generate, greedy_generate
from accelerate_tpu_torch.big_modeling import cache_factory_for
from accelerate_tpu_torch.generation import _make_warper
from accelerate_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
)
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

GEMMA2_STYLE = dict(layer_windows=(8, None), attn_logit_softcapping=5.0,
                    final_logit_softcapping=3.0, post_norms=True, rms_norm_unit_offset=True,
                    scale_embeddings=True, mlp_activation="gelu_tanh",
                    query_pre_attn_scalar=20.0, tie_word_embeddings=True)


def pair(overrides, seed=0):
    """The same perturbed weights in the JAX module and the port's model."""
    module = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**overrides))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = LlamaConfig.tiny(**overrides)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, params, model.eval()


def prompt(B=2, S=11, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def both(module, params, model, ids, **kw):
    ref = jax_generate(module, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids),
                       cache_dtype=jnp.float32, **kw)
    out = generate(model, torch.from_numpy(ids).long(), cache_dtype=torch.float32, **kw)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("name", ["tiny", "gemma2-style"])
def test_greedy_is_token_exact(name):
    module, params, model = pair(GEMMA2_STYLE if name == "gemma2-style" else {})
    ref, out = both(module, params, model, prompt(), max_new_tokens=12)
    assert out.shape == (2, 23)
    np.testing.assert_array_equal(out, ref)


def test_eos_latch_and_min_new_tokens_are_token_exact():
    module, params, model = pair({}, seed=2)
    ids = prompt(seed=3)
    free, _ = both(module, params, model, ids, max_new_tokens=10)
    eos = int(free[0, ids.shape[1] + 2])  # a token row 0 emits third
    for min_new in (0, 5):
        ref, out = both(module, params, model, ids, max_new_tokens=10, eos_token_id=eos,
                        min_new_tokens=min_new)
        np.testing.assert_array_equal(out, ref)
        row = out[0, ids.shape[1]:]
        hits = np.flatnonzero(row == eos)
        if min_new == 0:
            assert hits.size and hits[0] <= 2
        if hits.size:
            assert (row[hits[0]:] == eos).all()  # the latch holds
            assert hits[0] >= min_new


@pytest.mark.parametrize("penalty", [1.3, 0.8])
def test_repetition_penalty_is_token_exact(penalty):
    module, params, model = pair({}, seed=4)
    ref, out = both(module, params, model, prompt(seed=5), max_new_tokens=10,
                    repetition_penalty=penalty)
    np.testing.assert_array_equal(out, ref)


def test_greedy_generate_alias_and_empty_request():
    _, _, model = pair({}, seed=6)
    ids = torch.from_numpy(prompt(seed=7)).long()
    assert torch.equal(greedy_generate(model, ids, max_new_tokens=5, cache_dtype=torch.float32),
                       generate(model, ids, max_new_tokens=5, cache_dtype=torch.float32))
    assert torch.equal(generate(model, ids, max_new_tokens=0), ids)


@pytest.mark.parametrize("sampling", [(0.7, None, None), (1.0, 5, None), (1.0, None, 0.9),
                                      (0.8, 20, 0.5)], ids=["temperature", "top-k", "top-p", "all"])
def test_warper_matches_jax(sampling):
    logits = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32) * 3
    ref = np.asarray(jax_make_warper(sampling)(jnp.asarray(logits)))
    out = _make_warper(sampling)(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    keep = ~np.isneginf(ref)
    np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-6, atol=1e-6)


def test_sampling_is_seed_deterministic():
    _, _, model = pair({}, seed=9)
    ids = torch.from_numpy(prompt(seed=10)).long()

    knobs = dict(max_new_tokens=12, do_sample=True, temperature=1.5, top_k=50, top_p=0.95,
                 cache_dtype=torch.float32)

    def sample(seed):
        return generate(model, ids, generator=torch.Generator().manual_seed(seed), **knobs)

    assert torch.equal(sample(0), sample(0))
    assert not torch.equal(sample(0), sample(1))
    assert torch.equal(generate(model, ids, **knobs), sample(0))  # default seed 0


def test_generate_checks_its_inputs():
    _, _, model = pair({}, seed=11)
    ids = torch.from_numpy(prompt(seed=12)).long()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(model, ids, max_new_tokens=200)
    with pytest.raises(ValueError, match="repetition_penalty"):
        generate(model, ids, max_new_tokens=2, repetition_penalty=0.0)
    stacked = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert cache_factory_for(model) is not None and cache_factory_for(stacked) is None
    with pytest.raises(TypeError, match="KV cache"):
        generate(stacked, ids, max_new_tokens=2)
