"""The sampled serving engine: draws keyed by (seed, position), on the CPU.

JAX's threefry bits cannot be matched, so the port is held to two things:
its law is the JAX engine's (Gumbel-max over the JAX warper's distribution:
the empirical frequencies of many seeds against ``softmax`` of the JAX
``_make_warper`` on the same logits), and a request's tokens depend on its
seed alone, not on its slot, the batch around it, the ticking mode, the
layout or a preemption in between.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import _make_warper as jax_make_warper
from accelerate_tpu_torch.generation import _gumbel, _make_keyed_selector
from torch_serving_common import WAIT, make_engine, pair, prompts  # noqa: F401

SAMPLING = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.95)


@pytest.fixture(scope="module")
def model():
    return pair(seed=3)[2]


@pytest.mark.parametrize("sampling", [(1.0, None, None), (0.7, 5, None), (1.3, None, 0.8)],
                         ids=["plain", "top_k", "top_p"])
def test_keyed_draws_follow_the_jax_warped_law(sampling):
    V, N = 12, 20000
    logits = np.random.default_rng(0).normal(0.0, 1.5, (1, V)).astype(np.float32)
    warped = np.asarray(jax_make_warper(sampling)(jnp.asarray(logits))[0], np.float64)
    target = np.exp(warped - warped.max())
    target = target / target.sum()
    select = _make_keyed_selector(sampling)
    keys = torch.stack([torch.arange(N), torch.full((N,), 41)], dim=1)  # N seeds, one position
    draws = select(torch.from_numpy(logits).expand(N, V), keys, None).numpy()
    freq = np.bincount(draws, minlength=V) / N
    tv = 0.5 * np.abs(freq - target).sum()
    assert tv < 0.03, (tv, freq, target)  # ~0.01 expected from N draws
    assert np.all(freq[target == 0] == 0)  # warped-out tokens are never drawn


def test_noise_is_a_function_of_seed_and_position_only():
    keys = torch.tensor([[7, 3], [7, 3], [7, 4], [8, 3], [2**40 + 7, 3]])
    g = _gumbel(keys, 64)
    torch.testing.assert_close(g[0], g[1], rtol=0, atol=0)
    for other in (2, 3, 4):
        assert not torch.equal(g[0], g[other])
    assert torch.isfinite(g).all()
    # Uniform bits: the 64-bit seed's high half matters, and the noise of one
    # row is close to standard Gumbel in mean (0.5772) over many rows.
    many = _gumbel(torch.stack([torch.arange(4096), torch.zeros(4096, dtype=torch.long)], 1), 16)
    assert abs(many.mean().item() - 0.5772) < 0.02


def run(make_engine, model, prompt, seed, **kw):
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8, **SAMPLING, **kw)
    return engine, engine.submit(prompt, max_new_tokens=16, seed=seed)


@pytest.mark.parametrize("mode", ["neighbours-dense-sync", "neighbours-paged-async",
                                  "second-slot-paged-sync", "preempted-paged-async"])
def test_same_seed_same_tokens_whatever_the_batch(model, make_engine, mode):
    prompt = prompts([13], seed=21)[0]
    _, alone = run(make_engine, model, prompt, seed=5, paged=False, async_ticks=False)
    alone = alone.result(WAIT)
    others = prompts([6, 19, 11], seed=22)
    if mode.startswith("neighbours"):
        engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8,
                             paged=mode.endswith("paged-async"),
                             async_ticks=mode.endswith("async"), **SAMPLING)
        busy = [engine.submit(p, max_new_tokens=20, seed=99) for p in others[:2]]
        got = engine.submit(prompt, max_new_tokens=16, seed=5).result(WAIT)
        [r.result(WAIT) for r in busy]
    elif mode.startswith("second-slot"):
        engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8,
                             async_ticks=False, **SAMPLING)
        first = engine.submit(others[0], max_new_tokens=30, seed=1)  # holds slot 0
        req = engine.submit(prompt, max_new_tokens=16, seed=5)
        got = req.result(WAIT)
        first.result(WAIT)
    else:
        # 8 pages of 8 tokens for streams of up to 37 tokens: preemptions,
        # and the preempted stream resumes on its own seed and positions.
        engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8, max_pages=8,
                             prefix_cache_mb=0, async_ticks=True, **SAMPLING)
        busy = [engine.submit(p, max_new_tokens=26, seed=99) for p in others]
        got = engine.submit(prompt, max_new_tokens=16, seed=5).result(WAIT)
        [r.result(WAIT) for r in busy]
        assert engine.serving_metrics()["preemptions"] >= 1
    np.testing.assert_array_equal(got, alone)


def test_other_seeds_give_other_streams(model, make_engine):
    prompt = prompts([13], seed=21)[0]
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8, **SAMPLING)
    streams = [engine.submit(prompt, max_new_tokens=16, seed=s).result(WAIT) for s in (5, 6, 7)]
    assert len({tuple(s) for s in streams}) == 3
