"""The port's speculative decoders against the JAX package's, on the CPU.

``prompt_lookup_generate`` and ``assisted_generate`` are token-exact with the
JAX functions (and with plain greedy ``generate``) at fp32 on the same
numpy-seeded weights: repetitive and random prompts, EOS, a sliding-window
model (ring caches), and the JAX suite's edge lengths. Their validation
errors carry the JAX package's messages. ``speculative_emit``'s greedy branch
and its EOS latch are exact against the JAX function on the same logits, and
the prompt-lookup draft against a numpy transcription of the JAX rule.

Sampled paths draw from a ``torch.Generator``, so they are held to the
speculative-sampling theorem in distribution (the JAX suite's two tests:
20000 draws, every token's frequency within 0.015 of its target
probability, over 4.6 standard deviations of the worst case), to a tiny
temperature degenerating to greedy, and to seed determinism. A round reads
the device once, and nothing else does: counted with a dispatch mode that
refuses scalar reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu import generation as jax_generation
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu_torch import generation
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

# A round of K drafts commits at most K + 1 tokens.
K = 5


def pair(overrides=None, seed=3, layers=None):
    """The same perturbed weights in the JAX module and the port's model."""
    overrides = dict(overrides or {})
    if layers is not None:
        overrides["num_hidden_layers"] = layers
    module = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**overrides))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = LlamaConfig.tiny(**overrides)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def repetitive(n=4):
    return np.tile(np.array([[7, 11, 13]], np.int32), (1, n))


def spaced(S, mul=37, add=5):
    return (np.arange(S, dtype=np.int32)[None] * mul + add) % 256


def t(ids):
    return torch.from_numpy(ids).long()


def jax_greedy(module, params, ids, **kw):
    return np.asarray(jax_generation.generate(module, params, jnp.asarray(ids),
                                              cache_dtype=jnp.float32, **kw))


@pytest.mark.parametrize("kind", ["repetitive", "random"])
def test_prompt_lookup_is_token_exact(kind):
    module, params, model = pair()
    ids = repetitive() if kind == "repetitive" else spaced(12)
    ref = np.asarray(jax_generation.prompt_lookup_generate(
        module, params, jnp.asarray(ids), max_new_tokens=24, cache_dtype=jnp.float32))
    out = generation.prompt_lookup_generate(model, t(ids), max_new_tokens=24,
                                            cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jax_greedy(module, params, ids, max_new_tokens=24))
    stats = generation.last_speculation
    assert stats.committed == 24 and stats.reads == stats.rounds + 1
    assert stats.rounds == 23 - stats.accepted  # a round commits its accepted drafts and one


def test_prompt_lookup_with_eos_is_token_exact():
    module, params, model = pair()
    ids = (np.arange(10, dtype=np.int32)[None] * 3) % 256
    eos = int(jax_greedy(module, params, ids, max_new_tokens=16)[0, 14])
    ref = np.asarray(jax_generation.prompt_lookup_generate(
        module, params, jnp.asarray(ids), max_new_tokens=16, eos_token_id=eos,
        cache_dtype=jnp.float32))
    out = generation.prompt_lookup_generate(model, t(ids), max_new_tokens=16, eos_token_id=eos,
                                            cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[0, 10:] == eos).any()


def test_prompt_lookup_on_a_ring_cached_window_model():
    """Window 8 < the cache length: sliding-window layers decode from ring
    caches, whose stale slots after a rejected draft must stay masked."""
    module, params, model = pair({"sliding_window": 8})
    ids = np.tile(np.array([[5, 9]], np.int32), (1, 5))
    ref = np.asarray(jax_generation.prompt_lookup_generate(
        module, params, jnp.asarray(ids), max_new_tokens=20, cache_dtype=jnp.float32))
    out = generation.prompt_lookup_generate(model, t(ids), max_new_tokens=20,
                                            cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)
    assert "pos" in generation._cache_factory(model)(1, 256, torch.float32)[0]


def test_assisted_is_token_exact():
    module, params, model = pair()
    dmodule, dparams, dmodel = pair(seed=9, layers=1)
    ids = spaced(12)
    ref = np.asarray(jax_generation.assisted_generate(
        module, params, dmodule, dparams, jnp.asarray(ids), max_new_tokens=24,
        cache_dtype=jnp.float32))
    out = generation.assisted_generate(model, dmodel, t(ids), max_new_tokens=24,
                                       cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jax_greedy(module, params, ids, max_new_tokens=24))


def test_assisted_with_itself_as_draft_accepts_every_draft():
    """Draft == target: every draft passes, so a round commits K + 1 tokens
    and the first token plus ceil(23 / 6) rounds make 24."""
    module, params, model = pair()
    ids = spaced(12)
    out = generation.assisted_generate(model, model, t(ids), max_new_tokens=24, num_draft=K,
                                       cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, jax_greedy(module, params, ids, max_new_tokens=24))
    stats = generation.last_speculation
    assert stats.rounds == -(-23 // (K + 1)) == 4
    assert stats.accepted == 4 * K and stats.reads == 5


def test_assisted_with_eos_on_a_window_model_is_token_exact():
    module, params, model = pair({"sliding_window": 8})
    dmodule, dparams, dmodel = pair({"sliding_window": 8}, seed=9, layers=1)
    ids = np.tile(np.array([[5, 9]], np.int32), (1, 5))
    eos = int(jax_greedy(module, params, ids, max_new_tokens=20)[0, 16])
    ref = np.asarray(jax_generation.assisted_generate(
        module, params, dmodule, dparams, jnp.asarray(ids), max_new_tokens=20,
        eos_token_id=eos, cache_dtype=jnp.float32))
    out = generation.assisted_generate(model, dmodel, t(ids), max_new_tokens=20,
                                       eos_token_id=eos, cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("S,mnt,k", [(1, 8, 5), (3, 1, 5), (2, 2, 7), (5, 3, 1)])
def test_edge_lengths_stay_exact(S, mnt, k):
    """One-token prompts, one-token generations, more drafts than tokens to
    make: both decoders stay target-exact, as in the JAX suite."""
    module, params, model = pair()
    dmodule, dparams, dmodel = pair(seed=9, layers=1)
    ids = spaced(S, mul=13, add=2)
    ref = jax_greedy(module, params, ids, max_new_tokens=mnt)
    jax_assisted = np.asarray(jax_generation.assisted_generate(
        module, params, dmodule, dparams, jnp.asarray(ids), max_new_tokens=mnt, num_draft=k,
        cache_dtype=jnp.float32))
    np.testing.assert_array_equal(jax_assisted, ref)
    out = generation.assisted_generate(model, dmodel, t(ids), max_new_tokens=mnt, num_draft=k,
                                       cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)
    out = generation.prompt_lookup_generate(model, t(ids), max_new_tokens=mnt, num_draft=k,
                                            cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)


def raised(fn):
    with pytest.raises((ValueError, TypeError)) as info:
        fn()
    return type(info.value), str(info.value)


def test_validation_errors_match_the_jax_package():
    module, params, model = pair()
    dmodule, dparams, dmodel = pair(seed=9, layers=1)
    wide_cfg = dataclasses.replace(JaxLlamaConfig.tiny(), vocab_size=512)
    wide = JaxLlamaForCausalLM(wide_cfg)
    wide_params = wide.init_params(jax.random.PRNGKey(0))
    wide_model = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=512), device="cpu")
    two, one = np.zeros((2, 4), np.int32), np.zeros((1, 4), np.int32)
    cases = [
        (lambda: jax_generation.prompt_lookup_generate(module, params, two),
         lambda: generation.prompt_lookup_generate(model, t(two))),
        (lambda: jax_generation.prompt_lookup_generate(module, params, one, ngram=0),
         lambda: generation.prompt_lookup_generate(model, t(one), ngram=0)),
        (lambda: jax_generation.prompt_lookup_generate(module, params, one, num_draft=0),
         lambda: generation.prompt_lookup_generate(model, t(one), num_draft=0)),
        (lambda: jax_generation.prompt_lookup_generate(module, params, one, max_new_tokens=121),
         lambda: generation.prompt_lookup_generate(model, t(one), max_new_tokens=121)),
        (lambda: jax_generation.assisted_generate(module, params, dmodule, dparams, two),
         lambda: generation.assisted_generate(model, dmodel, t(two))),
        (lambda: jax_generation.assisted_generate(module, params, wide, wide_params, one),
         lambda: generation.assisted_generate(model, wide_model, t(one))),
        (lambda: jax_generation.assisted_generate(module, params, dmodule, dparams, one,
                                                  num_draft=0),
         lambda: generation.assisted_generate(model, dmodel, t(one), num_draft=0)),
        (lambda: jax_generation.assisted_generate(module, params, dmodule, dparams, one,
                                                  max_new_tokens=121),
         lambda: generation.assisted_generate(model, dmodel, t(one), max_new_tokens=121)),
        (lambda: jax_generation.beam_search_generate(module, params, one, max_new_tokens=125),
         lambda: generation.beam_search_generate(model, t(one), max_new_tokens=125)),
    ]
    for jax_call, port_call in cases:
        assert raised(port_call) == raised(jax_call)


def jax_emit(logits, draft, eos, prior_done):
    m, emit = jax_generation.speculative_emit(
        jnp.asarray(logits), jnp.asarray(draft), None, None, eos, jnp.int32,
        prior_done=None if prior_done is None else jnp.asarray(prior_done))
    return int(m), np.asarray(emit)


@pytest.mark.parametrize("prior_done", [None, False, True])
def test_speculative_emit_greedy_and_eos_latch_match_jax(prior_done):
    """Drafts that follow the argmax chain for a while, on logits whose
    chain passes through EOS at various places."""
    rng = np.random.default_rng(0)
    V = 16
    for trial in range(60):
        logits = rng.standard_normal((K + 1, V)).astype(np.float32)
        preds = logits.argmax(-1)
        eos = None if trial % 4 == 0 else int(preds[rng.integers(0, K + 1)])
        agree = int(rng.integers(0, K + 1))
        draft = np.where(np.arange(K) < agree, preds[:K], rng.integers(0, V, K)).astype(np.int32)
        ref_m, ref_emit = jax_emit(logits, draft, eos, prior_done)
        m, emit = generation.speculative_emit(
            torch.from_numpy(logits), torch.from_numpy(draft).long(), None, None, eos,
            torch.int64, prior_done=prior_done)
        assert int(m) == ref_m and emit.tolist() == ref_emit.tolist(), trial


def test_speculative_emit_sampled_latches_eos():
    """Sampled chains: accepted drafts, then the resample, then only EOS
    after the first EOS (or everywhere when the sequence was done)."""
    gen = torch.Generator().manual_seed(0)
    warp = generation._make_warper((1.0, None, None))
    eos = 3
    for trial in range(50):
        logits = torch.randn(K + 1, 8, generator=gen)
        draft = torch.randint(0, 8, (K,), generator=gen)
        for prior_done in (False, True):
            m, emit = generation.speculative_emit(logits, draft, gen, warp, eos, torch.int64,
                                                  prior_done=prior_done)
            emit = emit.tolist()
            if prior_done:
                assert emit == [eos] * (K + 1)
                continue
            first = emit.index(eos) if eos in emit else K + 1
            assert emit[first:] == [eos] * (K + 1 - first)
            assert emit[:min(int(m), first)] == draft.tolist()[:min(int(m), first)]


def reference_draft(buf, cur, ngram, k):
    """The JAX package's draft rule (``_compiled_lookup_generate``'s body),
    transcribed to numpy: ``dynamic_slice`` clamps its start into range."""
    L = len(buf)
    start = min(max(cur - ngram, 0), L - ngram)
    pattern = buf[start:start + ngram]
    windows = np.stack([np.roll(buf, -j) for j in range(ngram)], axis=1)
    idxs = np.arange(L)
    hit = (windows == pattern[None, :]).all(axis=1) & (idxs + ngram < cur)
    best = np.max(np.where(hit, idxs, -1))
    draft_start = int(np.clip(best + ngram, 0, L - k))
    return buf[draft_start:draft_start + k]


@settings(max_examples=300, deadline=None)
@given(data=st.data(), L=st.integers(10, 96), ngram=st.integers(1, 4), k=st.integers(1, 6),
       vocab=st.integers(2, 5))
def test_lookup_draft_is_the_jax_rule(data, L, ngram, k, vocab):
    buf = np.array(data.draw(st.lists(st.integers(0, vocab - 1), min_size=L, max_size=L)),
                   np.int64)
    cur = data.draw(st.integers(2, L - k - 1))
    np.testing.assert_array_equal(generation.lookup_draft(buf, cur, ngram, k),
                                  reference_draft(buf, cur, ngram, k))


DRAWS = 20000
ATOL = 0.015


def test_accept_rule_preserves_target_distribution():
    """K = 1: whatever the draft, the emitted token follows
    softmax(warped_logits[0])."""
    logits = torch.tensor([[2.0, 0.1, -1.0, 0.5, 1.5, -0.5, 0.0, 0.7], [0.0] * 8])
    target = torch.softmax(logits[0], -1).numpy()
    draft = torch.tensor([4])
    gen = torch.Generator().manual_seed(0)
    toks = []
    for _ in range(DRAWS):
        m, final = generation.speculative_accept(logits, draft, gen)
        toks.append(4 if int(m) >= 1 else int(final))
    emp = np.bincount(toks, minlength=8) / DRAWS
    np.testing.assert_allclose(emp, target, atol=ATOL)


def test_full_acceptance_bonus_samples_target():
    """A draft with all of position 0's mass is accepted (almost) always;
    the bonus token then follows position 1's target."""
    row0 = torch.full((8,), -30.0)
    row0[3] = 10.0
    row1 = torch.tensor([1.0, 0.0, 2.0, -1.0, 0.5, 0.2, -0.3, 0.8])
    logits = torch.stack([row0, row1])
    gen = torch.Generator().manual_seed(1)
    ms, finals = [], []
    for _ in range(DRAWS):
        m, final = generation.speculative_accept(logits, torch.tensor([3]), gen)
        ms.append(int(m))
        finals.append(int(final))
    assert np.mean(ms) > 0.999
    emp = np.bincount(finals, minlength=8) / DRAWS
    np.testing.assert_allclose(emp, torch.softmax(row1, -1).numpy(), atol=ATOL)


def test_tiny_temperature_degenerates_to_greedy():
    module, params, model = pair(seed=5)
    ids = np.tile(np.array([[9, 4, 17]], np.int32), (1, 4))
    out = generation.prompt_lookup_generate(model, t(ids), max_new_tokens=18, do_sample=True,
                                            temperature=1e-6, cache_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), jax_greedy(module, params, ids,
                                                          max_new_tokens=18))


@pytest.mark.parametrize("decoder", ["prompt_lookup", "assisted"])
def test_sampled_paths_are_seed_deterministic(decoder):
    _, _, model = pair(seed=6)
    _, _, dmodel = pair(seed=9, layers=1)
    ids = t((np.arange(10, dtype=np.int32)[None] * 7) % 256)

    def run(seed):
        kw = dict(max_new_tokens=12, do_sample=True, temperature=0.9, top_k=16,
                  cache_dtype=torch.float32, generator=torch.Generator().manual_seed(seed))
        if decoder == "assisted":
            return generation.assisted_generate(model, dmodel, ids, **kw)
        return generation.prompt_lookup_generate(model, ids, **kw)

    a, b = run(42), run(42)
    assert torch.equal(a, b) and a.shape == (1, 22)
    assert any(not torch.equal(a, run(seed)) for seed in range(3))


class RefuseScalarReads(TorchDispatchMode):
    """Fails on ``.item()``, ``bool()``, ``int()`` of a tensor: every read
    of the speculative loops goes through ``generation._read``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a scalar read of the device outside generation._read")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("do_sample", [False, True])
def test_one_read_of_the_device_per_round(do_sample, monkeypatch):
    _, _, model = pair()
    _, _, dmodel = pair(seed=9, layers=1)
    reads = []
    real_read = generation._read
    monkeypatch.setattr(generation, "_read", lambda x: reads.append(1) or real_read(x))
    ids = t(repetitive())
    for call in (lambda: generation.prompt_lookup_generate(model, ids, max_new_tokens=16,
                                                           do_sample=do_sample,
                                                           cache_dtype=torch.float32),
                 lambda: generation.assisted_generate(model, dmodel, ids, max_new_tokens=16,
                                                      do_sample=do_sample,
                                                      cache_dtype=torch.float32)):
        reads.clear()
        with RefuseScalarReads():
            call()
        stats = generation.last_speculation
        assert len(reads) == stats.reads == stats.rounds + 1 and stats.committed == 16
