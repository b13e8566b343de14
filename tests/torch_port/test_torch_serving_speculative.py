"""Speculative decoding in the port's serving engine against the JAX
package, on the CPU at tiny widths.

Greedy prompt-lookup and draft-model streams are token-exact with port
``generate`` (f32 cache) in both ticking modes, with the JAX engine's
speculative streams, through a prefix-cache hit whose draft K/V is
rebuilt, and under a forced preemption; a model drafting for itself has
every draft accepted. Sampled speculation draws with the position-keyed
noise of the decode step: a seed gives the same stream alone, beside
other streams, across a preemption and in either ticking mode; the
speculative streams follow the law of the JAX engine's, speculative and
plain (a two-sample chi-square over a fixed seed set), and the accept rule
itself follows its target distribution. After warmup no new step
signature appears. The host's lookup proposals are the JAX engine's."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch.generation import (
    _make_warper,
    generate,
    speculative_emit,
    speculative_emit_keyed,
)
from accelerate_tpu_torch.serving import ServingEngine
from torch_serving_common import WAIT, make_engine, pair, prompts, submit_staggered  # noqa: F401

K = 4
BASE = dict(max_slots=3, max_len=64, prefill_chunk=8)


@pytest.fixture(scope="module")
def tiny():
    module, params, model = pair(seed=0)
    dmodule, dparams, draft = pair(seed=9, num_hidden_layers=1)
    return module, params, model, dmodule, dparams, draft


def reference(model, prompt, max_new, eos=None):
    out = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=max_new,
                   eos_token_id=eos, cache_dtype=torch.float32)
    return out[0, prompt.shape[1]:].numpy()


#: A prompt on which the tiny model's greedy stream falls into a loop: its
#: n-grams recur, so prompt lookup hits and its proposals are accepted.
LOOPING = prompts((5,), seed=7)[0]


def work(seed=1):
    """Random prompts, one self-repeating, one looping; max_new 6-20."""
    ps = prompts((3, 9, 17, 26, 12), seed=seed)
    ps.append(np.tile(np.array([[4, 5, 6, 7]], np.int32), (1, 5)))
    return [(p, 6 + (i * 5) % 15) for i, p in enumerate(ps)] + [(LOOPING, 16)]


def spec_kwargs(mode, tiny):
    model, draft = tiny[2], tiny[5]
    return {"lookup": dict(spec_lookup=2, spec_tokens=K),
            "draft": dict(draft_model=draft, spec_tokens=K),
            "self": dict(draft_model=model, spec_tokens=K)}[mode]


def check(reqs, items, model, eos=None):
    for req, (prompt, max_new) in zip(reqs, items):
        got, ref = req.result(WAIT), reference(model, prompt, max_new, eos)
        np.testing.assert_array_equal(got, ref[:len(got)], err_msg=f"{prompt.shape[1]} tokens")
        if len(got) < max_new:
            assert got[-1] == eos and np.all(ref[len(got):] == eos)


@pytest.mark.parametrize("async_ticks", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("mode", ["lookup", "draft", "self"])
def test_greedy_spec_streams_equal_generate(tiny, make_engine, mode, async_ticks):
    model = tiny[2]
    engine = make_engine(model, **BASE, async_ticks=async_ticks, **spec_kwargs(mode, tiny))
    items = work()
    check(submit_staggered(engine, items), items, model)
    s = engine.serving_metrics()
    assert s["spec_ticks"] > 0 and s["spec_proposed_tokens"] > 0
    if mode != "draft":  # an unrelated random draft may accept nothing
        assert s["spec_accepted_tokens"] > 0, s
    if mode == "lookup":
        assert s["spec_lookup_hit_rate"] > 0, s


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_greedy_eos_latch_under_speculation(tiny, make_engine, mode):
    model = tiny[2]
    items = work(seed=3)
    eos = int(reference(model, *items[2])[3])  # a token one stream emits fourth
    engine = make_engine(model, **BASE, eos_token_id=eos, **spec_kwargs(mode, tiny))
    check(submit_staggered(engine, items), items, model, eos)


# The JAX engine's thread raises from its CompileWatcher.stop() on this jax
# version after it has served (see test_torch_serving_engine.py).
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_spec_streams_equal_the_jax_engine(tiny, make_engine, mode):
    module, params, model, dmodule, dparams, _ = tiny
    items = work(seed=5)
    jax_kw = (dict(spec_lookup=2) if mode == "lookup"
              else dict(draft_model=dmodule, draft_params=dparams))
    jax_engine = JaxServingEngine(module, params, **BASE, spec_tokens=K,
                                  cache_dtype=jnp.float32, async_ticks=False, **jax_kw)
    try:
        jax_streams = [r.result(WAIT) for r in submit_staggered(jax_engine, items)]
        jax_s = jax_engine.serving_metrics()
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    engine = make_engine(model, **BASE, async_ticks=False, **spec_kwargs(mode, tiny))
    port_streams = [r.result(WAIT) for r in submit_staggered(engine, items)]
    for (prompt, max_new), a, b in zip(items, jax_streams, port_streams):
        np.testing.assert_array_equal(b, np.asarray(a))
        np.testing.assert_array_equal(b, reference(model, prompt, max_new))
    assert jax_s["spec_ticks"] > 0 and engine.serving_metrics()["spec_ticks"] > 0


def test_self_draft_accepts_every_draft(tiny, make_engine):
    """The target drafting for itself proposes its own greedy tokens: every
    verify accepts all K drafts (streams of 1 + 3 (K+1) tokens, so no
    verify is cut short by a stream's budget)."""
    model = tiny[2]
    # Pages for every slot's target and draft: a preemption's resume would
    # commit a token outside a verify.
    engine = make_engine(model, **BASE, async_ticks=False, max_pages=48,
                         **spec_kwargs("self", tiny))
    items = [(p, 1 + 3 * (K + 1)) for p in prompts((5, 11, 20), seed=7)]
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in items]
    check(reqs, items, model)
    s = engine.serving_metrics()
    assert s["preemptions"] == 0
    assert s["spec_accepted_tokens"] == s["spec_proposed_tokens"] > 0, s


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_forced_preemption_under_speculation(tiny, make_engine, mode):
    """A pool too small for three speculating streams preempts one, which
    resumes token-exactly (its draft pages too)."""
    model = tiny[2]
    pages = 12 if mode == "draft" else 8
    engine = make_engine(model, **BASE, max_pages=pages, prefix_cache_mb=0,
                         **spec_kwargs(mode, tiny))
    items = [(p, 20) for p in prompts((12, 14, 9), seed=7)]
    check([engine.submit(p, max_new_tokens=n) for p, n in items], items, model)
    assert engine.serving_metrics()["preemptions"] >= 1


def test_draft_prefix_hit_rebuilds_draft_kv(tiny, make_engine):
    """A prompt whose prefix restores by page aliasing gets its draft K/V
    rebuilt by the draft chunk step; cold and warm streams equal generate."""
    model = tiny[2]
    engine = make_engine(model, **BASE, prefix_cache_mb=4.0, **spec_kwargs("draft", tiny))
    long = (np.arange(1, 28, dtype=np.int32)[None] * 7) % 256
    items = [(long, 16)]
    for _ in range(2):
        check([engine.submit(long, max_new_tokens=16)], items, model)
    s = engine.serving_metrics()
    assert s["prefix_alias_chunks"] >= 1, s
    assert engine.compile_watcher.counts() == {"chunk": 1, "spec": 1, "draft_chunk": 1}


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_no_new_step_signature_after_warmup(tiny, make_engine, mode):
    model = tiny[2]
    engine = make_engine(model, **BASE, **spec_kwargs(mode, tiny))
    watcher = engine.compile_watcher
    warm = watcher.counts()
    want = {"chunk": 1, "spec": 1}
    if mode == "draft":
        want["draft_chunk"] = 1
    assert warm == want
    items = work(seed=13)
    check(submit_staggered(engine, items + items[:2]), items + items[:2], model)
    assert watcher.events == [] and watcher.counts() == warm


# -- sampled speculation ------------------------------------------------------

SAMPLED = dict(do_sample=True, temperature=0.9, top_k=20)


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_sampled_spec_is_seed_deterministic(tiny, make_engine, mode):
    """Seed 7's stream is the same alone, beside 3 other streams, in the
    other ticking mode, across a forced preemption, and on the plain
    sampled engine (each token is the Gumbel-max sample of its position)."""
    model = tiny[2]
    items = work(seed=17)
    prompt, max_new = items[1][0], 24
    streams = {}
    pages = 12 if mode == "draft" else 8
    for label, kw, others in (("alone", dict(async_ticks=False), []),
                              ("beside 3", dict(async_ticks=True), items[2:5]),
                              ("preempted", dict(max_pages=pages, prefix_cache_mb=0), items[2:4])):
        engine = make_engine(model, **BASE, **SAMPLED, **spec_kwargs(mode, tiny), **kw)
        reqs = [engine.submit(p, max_new_tokens=20, seed=11 + i) for i, (p, _) in enumerate(others)]
        streams[label] = engine.submit(prompt, max_new_tokens=max_new, seed=7).result(WAIT)
        [r.result(WAIT) for r in reqs]
        if label == "preempted":
            assert engine.serving_metrics()["preemptions"] >= 1
    plain = make_engine(model, **BASE, **SAMPLED)
    streams["plain"] = plain.submit(prompt, max_new_tokens=max_new, seed=7).result(WAIT)
    for label, stream in streams.items():
        np.testing.assert_array_equal(stream, streams["alone"], err_msg=label)


# The JAX engine's thread raises from its CompileWatcher.stop() on this jax
# version after it has served (see test_torch_serving_engine.py).
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("reference", ["spec", "plain"], ids=["jax-spec", "jax-plain"])
def test_sampled_spec_law_matches_the_jax_engine(tiny, make_engine, reference):
    """Two-sample chi-square over 240 fixed seeds between the port's sampled
    draft-model speculation and the JAX engine's, either speculating with
    the same draft or plain sampled (same weights, same warp): the first
    token (drawn by the prompt's last chunk) and generation indices 1 and 2
    (drawn by the port's verify). The engines draw from independent noise
    (the port's position-keyed hash, JAX's split keys) under one law, so
    each column's p-value is that of two samples of one distribution; the
    test asserts p > 0.01 for each (on these seeds p = 0.54, 0.75, 0.85
    against the JAX speculative engine, 0.54, 0.49, 0.42 against the plain
    one)."""
    module, params, model, dmodule, dparams, draft = tiny
    prompt = prompts((6,), seed=23)[0]
    law = dict(do_sample=True, temperature=1.0, top_k=4)
    seeds = range(240)
    jax_kw = (dict(spec_tokens=K, draft_model=dmodule, draft_params=dparams)
              if reference == "spec" else {})
    jax_engine = JaxServingEngine(module, params, **BASE, **law, **jax_kw,
                                  cache_dtype=jnp.float32, max_queued=256)
    try:
        reqs = [jax_engine.submit(prompt, max_new_tokens=3, seed=s) for s in seeds]
        jax_toks = np.stack([np.asarray(r.result(WAIT)) for r in reqs])
        assert (jax_engine.serving_metrics()["spec_ticks"] > 0) == (reference == "spec")
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    engine = make_engine(model, **BASE, **law, draft_model=draft, spec_tokens=K,
                         max_queued=256)
    reqs = [engine.submit(prompt, max_new_tokens=3, seed=s) for s in seeds]
    port_toks = np.stack([r.result(WAIT) for r in reqs])
    assert engine.serving_metrics()["spec_ticks"] > 0
    assert jax_toks.shape == port_toks.shape == (len(seeds), 3)
    for col in range(3):
        a, b = jax_toks[:, col], port_toks[:, col]
        vocab = np.union1d(a, b)
        table = np.array([[np.sum(a == t) for t in vocab], [np.sum(b == t) for t in vocab]])
        assert table.shape[1] > 1, (col, table)   # the warp leaves more than one token
        p = stats.chi2_contingency(table)[1]
        assert p > 0.01, (col, table, p)


def test_keyed_accept_follows_the_target_law():
    """The accept rule alone on fixed logits over 4000 seeds: the first
    emitted token follows softmax(warp(logits[0])) (chi-square goodness of
    fit, p > 0.001; p = 0.34 here) and draft 0 passes with probability
    p_0(draft_0) (within 4 sigma)."""
    V, n = 6, 4000
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(1, K + 1, V)).astype(np.float32)).expand(n, -1, -1)
    draft = torch.tensor([[2, 0, 1, 3]]).expand(n, -1)
    warp = _make_warper((1.0, None, None))
    m, emit = speculative_emit_keyed(logits, draft, torch.arange(n), torch.full((n,), 10), warp,
                                     None, torch.int64, torch.zeros(n, dtype=torch.bool))
    target = torch.softmax(logits[0, 0].double(), -1).numpy()
    observed = np.bincount(emit[:, 0].numpy(), minlength=V)
    p = stats.chisquare(observed, target / target.sum() * n)[1]
    assert p > 0.001, (observed, target * n, p)
    accept = (m >= 1).float().mean().item()
    sigma = (target[2] * (1 - target[2]) / n) ** 0.5
    assert abs(accept - target[2]) < 4 * sigma, (accept, target[2])
    # Emitted tokens after the accepted drafts: the drafts themselves.
    passed = m >= 2
    assert torch.equal(emit[passed, :2], draft[passed, :2])


@pytest.mark.parametrize("eos", [None, 3])
def test_keyed_greedy_equals_speculative_emit(eos):
    """Greedy rows of the batched rule are :func:`speculative_emit`'s."""
    rng = np.random.default_rng(5)
    S, V = 6, 12
    logits = torch.from_numpy(rng.normal(size=(S, K + 1, V)).astype(np.float32))
    draft = torch.from_numpy(rng.integers(0, V, (S, K)))
    draft[0] = logits[0, :K].argmax(-1)        # a row that accepts all
    draft[1, :2] = logits[1, :2].argmax(-1)    # and one that accepts 2
    prior = torch.tensor([False, False, False, False, True, False])
    m, emit = speculative_emit_keyed(logits, draft, torch.zeros(S, dtype=torch.long),
                                     torch.zeros(S, dtype=torch.long), None, eos, torch.int64,
                                     prior)
    for s in range(S):
        m1, emit1 = speculative_emit(logits[s], draft[s], None, None, eos, torch.int64,
                                     prior_done=prior[s])
        assert int(m[s]) == int(m1) and torch.equal(emit[s], emit1)
    assert int(m[0]) == K and int(m[1]) >= 2


def test_lookup_proposals_are_the_jax_engines():
    rng = np.random.default_rng(29)
    for n in (1, 2, 3):
        fake = types.SimpleNamespace(_spec_k=K, _spec_lookup=n)
        for trial in range(20):
            prompt = rng.integers(0, 5, (1, int(rng.integers(1, 30)))).astype(np.int32)
            tokens = [int(t) for t in rng.integers(0, 5, int(rng.integers(0, 10)))]
            req = types.SimpleNamespace(_serve_ids=prompt, _pos_base=prompt.shape[1] - 1,
                                        tokens=tokens)
            want, want_hit = JaxServingEngine._lookup_proposals(fake, req)
            got, hit = ServingEngine._lookup_proposals(fake, req)
            np.testing.assert_array_equal(got, want)
            assert hit == want_hit


def test_spec_validation_and_page_accounting(tiny):
    model, draft = tiny[2], tiny[5]
    kw = dict(device="cpu", autostart=False)
    with pytest.raises(NotImplementedError, match="paged"):
        ServingEngine(model, paged=False, draft_model=draft, **kw)
    with pytest.raises(ValueError, match="spec_tokens"):
        ServingEngine(model, draft_model=draft, spec_tokens=0, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(model, draft_model=draft, spec_lookup=3, **kw)
    with pytest.raises(ValueError, match="spec_lookup"):
        ServingEngine(model, spec_lookup=0, **kw)
    _, _, other = pair(seed=2, vocab_size=128)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(model, draft_model=other, **kw)
    engine = ServingEngine(model, max_len=64, prefill_chunk=8, draft_model=draft, **kw)
    plain = ServingEngine(model, max_len=64, prefill_chunk=8, **kw)
    try:
        # A draft engine holds a draft page beside every target page.
        assert engine.page_deficit(9999) == 2 * plain.page_deficit(9999) + plain.free_pages
        assert engine.page_pool_metrics()["draft_page_bytes"] > 0
        assert engine._pages_per_slot == plain._pages_per_slot + 1  # max_len + K positions
    finally:
        engine.shutdown()
        plain.shutdown()
