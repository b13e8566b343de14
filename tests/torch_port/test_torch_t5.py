"""The port's T5 against the JAX package's, on the CPU, from the same
perturbed flax params at f32 (``state_dict_from_flax``).

* The forward in its three modes (train, encode, and cached decode step by
  step, whose cache and cross K/V are compared too), relu-tied and
  gated-untied (v1.1/flan): within 2e-5.
* ``relative_position_bucket``: the whole table for relative positions
  -4096..4096, bidirectional and causal, at (32, 128) and (8, 32)
  buckets, equal to the JAX table.
* ``seq2seq_generate``: token-exact with the JAX call across source lengths
  3, 8, 13 and 130 (both sides of the 128 bucket), greedy, with an EOS
  (and ``min_new_tokens``), and with ``repetition_penalty``; ``generate``
  hands T5 to it. Sampling: seed-deterministic, and the first token's
  empirical law on 2000 rows within 0.06 (total variation) of the warped
  softmax of the JAX model's first-step logits.
* The decoder-only decoders and ``ServingEngine`` refuse T5.
* ``seq2seq_lm_loss`` within 2e-5 of the JAX loss with and without
  ``decoder_attention_mask``; dropout from the loss's generator; three
  ``compile_train_step`` AdamW steps within 1e-5 of the JAX
  ``Accelerator``'s at dropout 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.generation import seq2seq_generate as jax_seq2seq
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu_torch import (
    Accelerator,
    ServingEngine,
    T5Config,
    T5ForConditionalGeneration,
    assisted_generate,
    beam_search_generate,
    generate,
    prompt_lookup_generate,
    seq2seq_generate,
    seq2seq_lm_loss,
)
from accelerate_tpu_torch.big_modeling import cache_factory_for
from accelerate_tpu_torch.generation import _make_warper
from accelerate_tpu_torch.models import t5 as pt5
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

TOL = dict(atol=2e-5, rtol=2e-5)
VARIANTS = {"relu-tied": {}, "gated-untied": dict(feed_forward_proj="gated-gelu",
                                                  tie_word_embeddings=False)}


def perturbed(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def t5_pair(variant="gated-untied", seed=0, scale=0.5, **overrides):
    """The same perturbed weights in the JAX module and the port's model."""
    kw = {"dropout_rate": 0.0, **VARIANTS[variant], **overrides}
    module = jt5.T5ForConditionalGeneration(jt5.T5Config.tiny(**kw))
    params = perturbed(module.init_params(jax.random.PRNGKey(seed), 2, 8, 6), seed, scale)
    cfg = T5Config.tiny(**kw)
    model = T5ForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, params, model


def inputs(B=2, S=13, T=7, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, S - 4:] = 0
    dmask = np.ones((B, T), np.int32)
    dmask[0, T - 2:] = 0
    return dict(input_ids=rng.integers(2, 512, (B, S)).astype(np.int32),
                labels=rng.integers(2, 512, (B, T)).astype(np.int32), attention_mask=mask,
                decoder_attention_mask=dmask)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", ["train", "encode", "decode"])
def test_modes_match_jax(variant, mode):
    module, params, model = t5_pair(variant, scale=0.05)
    b = inputs()
    src, tgt, mask = b["input_ids"], b["labels"], b["attention_mask"]
    jitted = jax.jit(lambda p, *a, **kw: module.apply({"params": p}, *a, **kw),
                     static_argnames="mode")
    apply = lambda *a, **kw: jitted(params, *a, **kw)  # noqa: E731
    with torch.no_grad():
        if mode == "train":
            ref = apply(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
                        jnp.asarray(b["decoder_attention_mask"]))
            got = model(t(src), t(tgt), t(mask), t(b["decoder_attention_mask"]))
            assert got.shape == (2, 7, 512)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
            return
        enc_ref = apply(jnp.asarray(src), attention_mask=jnp.asarray(mask), mode="encode")
        enc = model(t(src), attention_mask=t(mask), mode="encode")
        np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), **TOL)
        if mode == "encode":
            return
        # Each step's cached logits, the caches and the cross K/V.
        jcache, cache = module.init_decode_cache(2, 7, jnp.float32), model.init_decode_cache(
            2, 7, torch.float32)
        jckv = ckv = None
        for pos in range(7):
            step = tgt[:, pos:pos + 1]
            ref, jcache, jckv = apply(decoder_input_ids=jnp.asarray(step),
                                      attention_mask=jnp.asarray(mask), mode="decode",
                                      encoder_out=enc_ref, cache=jcache,
                                      cache_pos=jnp.int32(pos), cross_kv=jckv)
            got, cache, new_ckv = model(decoder_input_ids=t(step), attention_mask=t(mask),
                                        mode="decode", encoder_out=enc, cache=cache,
                                        cache_pos=pos, cross_kv=ckv)
            ckv = new_ckv if ckv is None else ckv
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        for ours, theirs in zip(cache, jcache):
            for key in ("k", "v"):
                np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), **TOL)
        for ours, theirs in zip(ckv, jckv):
            for a, b_ in zip(ours, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)
        # The cached steps give the teacher-forced forward's logits.
        full = model(t(src), t(tgt), t(mask))
        np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, -1], atol=2e-4)


@pytest.mark.parametrize("buckets", [(32, 128), (8, 32)], ids=["32-128", "8-32"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
def test_bucket_table_equals_jax(buckets, bidirectional):
    """Every relative position in -4096..4096: the reference's float32
    ``log(n / max_exact + 1e-6)`` truncated, bucket for bucket."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, *buckets))
    got = pt5.relative_position_bucket(t(rel), bidirectional, *buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # And as the model looks it up: a [q, k] table of int64 positions.
    grid = torch.arange(300)[None, :] - torch.arange(300)[:, None]
    table = pt5.relative_position_bucket(grid, bidirectional, *buckets)
    np.testing.assert_array_equal(table.numpy(), ref[4096 + grid.numpy()])


def both(module, params, model, src, **kw):
    ref = jax_seq2seq(module, params, jnp.asarray(src), cache_dtype=jnp.float32, **kw)
    got = seq2seq_generate(model, t(src), cache_dtype=torch.float32, **kw)
    return np.asarray(ref), got.numpy()


GENERATE = {"greedy": {}, "eos": dict(min_new_tokens=0), "eos-min-new": dict(min_new_tokens=4),
            "repetition-penalty": dict(repetition_penalty=1.7)}


@pytest.mark.parametrize("case", list(GENERATE))
def test_seq2seq_generate_is_token_exact(case):
    """Sources of 3, 8, 13 and 130 tokens (both sides of the 128 bucket);
    the EOS is a token the greedy run emits third for the 3-token source."""
    module, params, model = t5_pair(seed=2)
    sources = [np.random.default_rng(S).integers(2, 512, (2, S)).astype(np.int32)
               for S in (3, 8, 13, 130)]
    kw = dict(GENERATE[case], max_new_tokens=10)
    if case != "greedy":
        kw["eos_token_id"] = eos = int(seq2seq_generate(model, t(sources[0]),
                                                        max_new_tokens=3)[0, 3])
    for src in sources:
        ref, got = both(module, params, model, src, **kw)
        assert got.shape == (2, 11) and (got[:, 0] == 0).all()
        np.testing.assert_array_equal(got, ref)
        if case.startswith("eos"):
            hits = np.flatnonzero(got[0, 1:] == eos)
            if src is sources[0] and case == "eos":
                assert hits.size and hits[0] <= 2
            if hits.size:
                assert (got[0, 1 + hits[0]:] == eos).all()  # the latch holds
                assert hits[0] >= kw["min_new_tokens"]


def test_generate_hands_t5_to_seq2seq_generate():
    module, params, model = t5_pair(seed=3)
    src = np.random.default_rng(4).integers(2, 512, (1, 9)).astype(np.int32)
    out = generate(model, t(src), max_new_tokens=5, cache_dtype=torch.float32)
    assert out.shape == (1, 6)
    assert torch.equal(out, seq2seq_generate(model, t(src), max_new_tokens=5,
                                             cache_dtype=torch.float32))
    assert torch.equal(seq2seq_generate(model, t(src), max_new_tokens=0),
                       torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="src_len"):
        cache_factory_for(model)(1, 8, torch.float32)
    caches = cache_factory_for(model)(1, 8, torch.float32, src_len=128)
    assert len(caches) == 2 and caches[0]["ck"].shape == (1, 128, 4, 16)


def test_sampling_is_seeded_and_agrees_in_distribution():
    module, params, model = t5_pair(seed=5, scale=0.1)
    src = inputs()["input_ids"][:1]
    knobs = dict(do_sample=True, temperature=1.3, top_k=8)

    def sample(seed, rows=1, new=6):
        return seq2seq_generate(model, t(src.repeat(rows, 0)), max_new_tokens=new,
                                generator=torch.Generator().manual_seed(seed), **knobs)

    assert torch.equal(sample(0), sample(0)) and not torch.equal(sample(0), sample(1))
    # The first token's law: the warped softmax of the JAX model's logits
    # at the start token (the teacher-forced forward's first position).
    logits = module.apply({"params": params}, jnp.asarray(src),
                          jnp.zeros((1, 7), jnp.int32))[:, 0]
    target = torch.softmax(_make_warper((1.3, 8, None))(t(np.array(logits))), -1)[0]
    draws = np.concatenate([sample(seed, rows=500, new=1)[:, 1].numpy() for seed in range(4)])
    law = np.bincount(draws, minlength=512) / draws.size
    assert 0.5 * np.abs(law - target.numpy()).sum() < 0.06


def test_decoder_only_decoders_and_the_engine_refuse_t5():
    _, _, model = t5_pair(seed=8)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="prompt_lookup_generate supports decoder-only"):
        prompt_lookup_generate(model, ids, max_new_tokens=2)
    with pytest.raises(TypeError, match="the target model is encoder-decoder"):
        assisted_generate(model, model, ids, max_new_tokens=2)
    with pytest.raises(TypeError, match="beam_search_generate supports decoder-only"):
        beam_search_generate(model, ids, max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="encoder-decoder models go through "
                                                  "seq2seq_generate"):
        ServingEngine(model, device="cpu", autostart=False, warmup=False)


@pytest.mark.parametrize("masked", [True, False], ids=["decoder-mask", "no-mask"])
def test_loss_matches_jax(masked):
    module, params, model = t5_pair("relu-tied", seed=9, scale=0.05)
    b = inputs(seed=10)
    if not masked:
        del b["decoder_attention_mask"]
    ref = jt5.seq2seq_lm_loss(module.apply)(params, {k: jnp.asarray(v) for k, v in b.items()})
    got = seq2seq_lm_loss(model)(dict(model.named_parameters()), {k: t(v) for k, v in b.items()})
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


def test_dropout_draws_from_the_loss_generator():
    _, _, model = t5_pair(seed=11, dropout_rate=0.3)
    b = {k: t(v) for k, v in inputs(seed=12).items()}
    loss_fn = seq2seq_lm_loss(model)
    params = dict(model.named_parameters())

    def loss(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return loss_fn(params, b, gen).item()

    assert loss(7) == loss(7) and loss(7) != loss(8)
    assert loss(None) == loss(None) != loss(7)


def test_train_steps_match_jax():
    module, params, model = t5_pair("gated-untied", seed=13, scale=0.05)
    batches = [inputs(B=4, seed=s) for s in (14, 15, 16)]
    jacc = JaxAccelerator(mixed_precision="no")
    jacc.prepare(Model(module, params), optax.adamw(1e-4, weight_decay=1e-4))
    jstep = jacc.compile_train_step(jt5.seq2seq_lm_loss(module.apply), max_grad_norm=1.0)
    ref = [float(jstep({k: jnp.asarray(v) for k, v in b.items()})["loss"]) for b in batches]
    acc = Accelerator(cpu=True)
    pmodel, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                     weight_decay=1e-4))
    step = acc.compile_train_step(seq2seq_lm_loss(pmodel), max_grad_norm=1.0)
    got = [step({k: t(v) for k, v in b.items()})["loss"].item() for b in batches]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_flax_params_cross_by_name_with_each_stack_counted():
    """``encoder_layer_<i>``/``decoder_layer_<i>`` become ``.<i>`` lists,
    the tied head stays the shared embedding, and a config whose
    ``num_layers`` disagrees with either stack is refused."""
    _, params, model = t5_pair("relu-tied", seed=14)
    state = state_dict_from_flax(params, model.config)
    assert "encoder_layer.1.mlp.mlp_out.weight" in state and "lm_head.weight" not in state
    assert torch.equal(state["decoder_layer.0.self_attention.query.weight"],
                       t(params["decoder_layer_0"]["self_attention"]["query"]["kernel"].T))
    with pytest.raises(ValueError, match="coder_layer layers, config says 3"):
        state_dict_from_flax(params, T5Config.tiny(num_layers=3))
