"""The port's beam search against the JAX package's, on the CPU.

``beam_search_generate`` is token-exact with ``accelerate_tpu.generation.
beam_search_generate`` at fp32 (f32 KV cache) on the same numpy-seeded
weights: 1, 3 and 4 beams, with and without EOS (an EOS the beams reach
within a few steps, so frozen beams meet live ones), length penalties 0.5,
1 and 2, batch 1 and 2, and a sliding-window model whose ring caches (and
their position buffers) follow the beams. One beam is greedy ``generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jax_generation
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu_torch import beam_search_generate, generate
from accelerate_tpu_torch.generation import _top_k_by_index
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

NEW = 8


def pair(overrides=None, seed=1):
    """The same perturbed weights in the JAX module and the port's model."""
    module = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**(overrides or {})))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = LlamaConfig.tiny(**(overrides or {}))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def prompt(B, S=9, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def both(module, params, model, ids, **kw):
    ref = jax_generation.beam_search_generate(module, params, jnp.asarray(ids),
                                              cache_dtype=jnp.float32, **kw)
    out = beam_search_generate(model, torch.from_numpy(ids).long(),
                               cache_dtype=torch.float32, **kw)
    return np.asarray(ref), out.numpy()


def early_eos(module, params, model, ids, num_beams):
    """The third token of row 0's best beam without EOS: with it as EOS, a
    beam freezes within three steps, whether or not it goes on to win."""
    free, _ = both(module, params, model, ids, max_new_tokens=NEW, num_beams=num_beams)
    return int(free[0, ids.shape[1] + 2])


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("num_beams", [1, 3, 4])
def test_beam_search_is_token_exact(num_beams, with_eos, batch):
    module, params, model = pair()
    ids = prompt(batch)
    eos = early_eos(module, params, model, ids, num_beams) if with_eos else None
    ref, out = both(module, params, model, ids, max_new_tokens=NEW, num_beams=num_beams,
                    eos_token_id=eos)
    assert out.shape == (batch, ids.shape[1] + NEW)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("length_penalty", [0.5, 2.0])
def test_length_penalty_is_token_exact(length_penalty):
    module, params, model = pair(seed=4)
    ids = prompt(2, seed=5)
    eos = early_eos(module, params, model, ids, 4)
    ref, out = both(module, params, model, ids, max_new_tokens=NEW, num_beams=4,
                    eos_token_id=eos, length_penalty=length_penalty)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("num_beams", [3, 4])
def test_ring_cached_window_model_is_token_exact(num_beams):
    """Window 8 < the cache length: the ring caches' k, v and pos rows are
    gathered with their beams, and decode wraps the ring."""
    module, params, model = pair({"sliding_window": 8}, seed=3)
    ids = prompt(2, S=6, seed=6)
    ref, out = both(module, params, model, ids, max_new_tokens=12, num_beams=num_beams)
    np.testing.assert_array_equal(out, ref)


def test_one_beam_is_greedy_generate():
    _, _, model = pair(seed=7)
    ids = torch.from_numpy(prompt(2, seed=8)).long()
    beam = beam_search_generate(model, ids, max_new_tokens=NEW, num_beams=1,
                                cache_dtype=torch.float32)
    greedy = generate(model, ids, max_new_tokens=NEW, cache_dtype=torch.float32)
    assert torch.equal(beam, greedy)


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    """Frozen beams make exact ties (every non-EOS continuation of a frozen
    beam scores -1e9 more); selection must follow ``jax.lax.top_k``."""
    scores = np.array([[0.5, -1e9, 0.5, -1e9, 0.25, 0.5, -1e9, -1e9]], np.float32)
    for k in (1, 3, 5):
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(scores), k)
        vals, idx = _top_k_by_index(torch.from_numpy(scores), k)
        assert idx.tolist() == np.asarray(ref_idx).tolist()
        assert vals.tolist() == np.asarray(ref_vals).tolist()
