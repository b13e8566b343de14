"""Sliding-window models under paging, the monolithic prefill path, and the
paged engine's constructor checks, in the port against the JAX package on
the CPU at tiny widths.

A model whose every layer has a window narrower than ``max_len`` serves on
the paged engine token-exact with ``generate`` and with the JAX engine, and
frees the pages wholly behind its window: the same window floor, token by
token, as the JAX engine's ``_page_floor``; with speculation too. Mixed
local/global windows serve without freeing. ``prefill_chunk=None`` prefills
each prompt whole per 128-bucket, token-exact with JAX (greedy) and with
the chunked engine (sampled, draws keyed by position), one step signature
per bucket used. ``TestPagedValidation``'s constructor combinations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch.generation import generate
from accelerate_tpu_torch.serving import PrefixCache, ServingEngine
from torch_serving_common import WAIT, make_engine, pair, prompts, submit_staggered  # noqa: F401

EOS = 7
WINDOW = 16


@pytest.fixture(scope="module")
def ring():
    return pair(seed=0, sliding_window=WINDOW)


def reference(model, prompt, max_new, eos=None):
    out = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=max_new,
                   eos_token_id=eos, cache_dtype=torch.float32)
    return out[0, prompt.shape[1]:].numpy()


def floors(engine, prompt, n):
    """Serve one stream (sync ticks, callbacks inline on the engine thread):
    its tokens, and after each token its window floor and the pool's pages
    in use."""
    seen = []
    holder = {}

    def on_token(_):
        seen.append((holder["req"]._page_floor, engine.page_pool_metrics()["pages_used"]))

    holder["req"] = engine.submit(prompt, max_new_tokens=n, ignore_eos=True, on_token=on_token)
    return np.asarray(holder["req"].result(WAIT)), seen


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_window_frees_pages_like_the_jax_engine(ring, make_engine):
    """8 + 40 positions would hold 6 pages of 8; a 16-token window keeps at
    most 3 live (+1 being written). The floor moves token for token as the
    JAX engine's, and the tokens are generate's and the JAX engine's."""
    module, params, model = ring
    prompt = np.array([[3, 5, 7, 11, 2, 8, 6, 4]], np.int32)
    kw = dict(max_slots=2, max_len=64, eos_token_id=EOS, prefill_chunk=8, prefix_cache_mb=0.0,
              async_ticks=False)
    jax_engine = JaxServingEngine(module, params, cache_dtype=jnp.float32, **kw)
    try:
        assert jax_engine._page_window == WINDOW
        want, want_seen = floors(jax_engine, prompt, 40)
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    engine = make_engine(model, **kw)
    assert engine._page_window == WINDOW
    got, seen = floors(engine, prompt, 40)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reference(model, prompt, 40))
    assert seen == want_seen
    assert max(used for _, used in seen) <= 4 and seen[-1][0] >= 3
    assert engine.page_pool_metrics()["window_pages_freed"] >= 3


@pytest.mark.parametrize("async_ticks", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("spec", [dict(), dict(spec_lookup=2), dict(draft_model="linear")],
                         ids=["decode", "lookup", "draft"])
def test_window_streams_equal_generate(ring, make_engine, spec, async_ticks):
    """Staggered streams of up to 48 positions on a 16-token window, with
    page freeing, in each ticking mode and under speculation (the draft's
    own cache must be linear)."""
    model = ring[2]
    kw = {k: (pair(seed=9, num_hidden_layers=1)[2] if v == "linear" else v)
          for k, v in spec.items()}
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8, async_ticks=async_ticks,
                         **kw)
    work = [(p, 30) for p in prompts((3, 9, 17, 12), seed=4)]
    for req, (p, n) in zip(submit_staggered(engine, work), work):
        np.testing.assert_array_equal(req.result(WAIT), reference(model, p, n))
    assert engine.page_pool_metrics()["window_pages_freed"] > 0
    assert engine.compile_watcher.events == []


def test_mixed_windows_serve_without_freeing(make_engine):
    """Local and global layers (Gemma2-style): no page may be freed, and
    the streams are generate's."""
    _, _, model = pair(seed=2, layer_windows=(WINDOW, None))
    engine = make_engine(model, max_slots=2, max_len=64, prefill_chunk=8, prefix_cache_mb=0.0)
    assert engine._page_window is None
    for p in prompts((5, 20), seed=6):
        np.testing.assert_array_equal(engine.submit(p, max_new_tokens=30).result(WAIT),
                                      reference(model, p, 30))
    assert engine.serving_metrics()["pages_used_max"] >= 6


def test_dense_engine_refuses_a_ring_model(ring):
    with pytest.raises(NotImplementedError, match="paged engine"):
        ServingEngine(ring[2], max_len=64, paged=False, device="cpu", autostart=False)
    with pytest.raises(NotImplementedError, match="paged engine"):
        ServingEngine(ring[2], max_len=64, prefill_chunk=None, device="cpu", autostart=False)
    with pytest.raises(NotImplementedError, match="linear"):
        ServingEngine(ring[2], max_len=64, draft_model=ring[2], device="cpu", autostart=False)


# -- monolithic prefill ----------------------------------------------------------

@pytest.fixture(scope="module")
def long_positions():
    return pair(seed=0, max_position_embeddings=512)


MONO = dict(max_slots=3, max_len=400, prefill_chunk=None)


def mono_work():
    """Prompts in the 128, 256 and 384 buckets."""
    return [(p, 10) for p in prompts((5, 100, 130, 260, 3), seed=8)]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_monolithic_equals_the_jax_engine_one_signature_per_bucket(long_positions, make_engine):
    module, params, model = long_positions
    work = mono_work()
    jax_engine = JaxServingEngine(module, params, **MONO, cache_dtype=jnp.float32,
                                  async_ticks=False)
    try:
        assert not jax_engine.paged
        want = [np.asarray(r.result(WAIT)) for r in submit_staggered(jax_engine, work)]
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    engine = make_engine(model, **MONO)
    assert not engine.paged and engine.prefix_cache is None
    watcher = engine.compile_watcher
    assert watcher.counts() == {"prefill_128": 1, "decode": 1}  # warmup: the smallest bucket
    got = [r.result(WAIT) for r in submit_staggered(engine, work)]
    for (p, n), a, b in zip(work, want, got):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, reference(model, p, n))
    # One new signature for each bucket first used after warmup, none repeated.
    assert sorted(watcher.events) == ["prefill_256", "prefill_384"]
    assert watcher.counts() == {"prefill_128": 1, "prefill_256": 1, "prefill_384": 1, "decode": 1}
    [r.result(WAIT) for r in submit_staggered(engine, work[::-1])]
    assert len(watcher.events) == 2


def test_monolithic_sampled_equals_chunked(long_positions, make_engine):
    """Draws are keyed by seed and position: a sampled stream is the same
    whether its prompt was prefilled whole or in chunks."""
    model = long_positions[2]
    sampled = dict(do_sample=True, temperature=0.9, top_k=40, max_slots=2, max_len=400)
    whole = make_engine(model, prefill_chunk=None, **sampled)
    chunked = make_engine(model, prefill_chunk=64, **sampled)
    for i, (p, n) in enumerate(mono_work()[:3]):
        np.testing.assert_array_equal(whole.submit(p, max_new_tokens=n, seed=i).result(WAIT),
                                      chunked.submit(p, max_new_tokens=n, seed=i).result(WAIT))


# -- constructor validation (TestPagedValidation) ------------------------------------

def test_constructor_combos(long_positions):
    model = long_positions[2]
    kw = dict(device="cpu", autostart=False)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(model, paged=True, prefill_chunk=None, **kw)
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(model, prefill_chunk=8, page_size=3, **kw)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, paged=False, prefill_chunk=8, page_size=8, **kw)
    with pytest.raises(ValueError, match="max_pages"):
        ServingEngine(model, prefill_chunk=8, max_pages=0, **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(model, prefill_chunk=None, prefix_cache=PrefixCache(1 << 20), **kw)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(model, prefill_chunk=0, **kw)


def test_submit_rejects_unsatisfiable_footprint(long_positions, make_engine):
    engine = make_engine(long_positions[2], max_slots=2, max_len=64, eos_token_id=EOS,
                         prefill_chunk=8, max_pages=4, warmup=False)
    with pytest.raises(ValueError, match="KV pages"):
        engine.submit(np.array([[3, 5, 7, 11, 2]], np.int32), max_new_tokens=40)
