"""The port's serving engine against the JAX package, on the CPU.

Greedy streams are token-exact with JAX ``generate`` (f32 cache, the same
weights) under every layout and ticking mode: dense and paged, sync and
async, chunk widths 8 and 16 against prompts of 1-40 tokens arriving
staggered, a prefix-cache restore (by page aliasing, and by copy), a forced
preemption, and a failing ``on_token`` callback that fails only its own
request. One staggered round is held against the JAX ``ServingEngine``
itself. After warmup no new step signature appears, whatever the mix of
prompt lengths (on the card: no new CUDA-graph capture). The tensor-position
cached forward the engine's steps run is held against batch-1 forwards, and
the chunk step's prefill epilogue against the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch.models.llama import init_kv_cache
from accelerate_tpu_torch.serving import PrefixCache, RequestStatus
from torch_serving_common import WAIT, Oracle, make_engine, pair, prompts, submit_staggered  # noqa: F401

LENGTHS = (1, 2, 7, 8, 9, 15, 16, 17, 23, 31, 32, 33, 40)


@pytest.fixture(scope="module")
def tiny():
    module, params, model = pair(seed=0)
    return module, params, model, Oracle(module, params)


def items(lengths=LENGTHS, seed=1):
    """(prompt, max_new) pairs: max_new varies 4..12 and keeps S + max_new
    within the engines' max_len of 64."""
    return [(p, 4 + (i * 5) % 9) for i, p in enumerate(prompts(lengths, seed))]


def check_streams(reqs, work, oracle):
    for req, (prompt, max_new) in zip(reqs, work):
        got = req.result(WAIT)
        np.testing.assert_array_equal(got, oracle(prompt, max_new),
                                      err_msg=f"prompt of {prompt.shape[1]} tokens")


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("async_ticks", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_staggered_streams_equal_jax_generate(tiny, make_engine, paged, async_ticks, chunk):
    _, _, model, oracle = tiny
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=chunk, paged=paged,
                         async_ticks=async_ticks)
    work = items()
    check_streams(submit_staggered(engine, work), work, oracle)
    s = engine.serving_metrics()
    assert s["requests_completed"] == len(work)
    assert s["tokens_emitted"] == sum(n for _, n in work)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eos_stops_streams_as_generate_latches(tiny, make_engine, paged):
    _, _, model, oracle = tiny
    work = items(seed=3)
    eos = int(oracle(*work[4])[2])  # a token one stream emits third
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=16, paged=paged,
                         eos_token_id=eos)
    hits = 0
    for req, (prompt, max_new) in zip(submit_staggered(engine, work), work):
        got, ref = req.result(WAIT), oracle(prompt, max_new, eos_token_id=eos)
        # The engine stops AT eos; generate keeps the shape and pads with eos.
        np.testing.assert_array_equal(got, ref[:len(got)])
        if len(got) < max_new:
            hits += 1
            assert got[-1] == eos and np.all(ref[len(got):] == eos)
    assert hits >= 1


@pytest.mark.parametrize("layout", ["dense", "paged-alias", "paged-copy"])
def test_repeat_prompt_restores_its_prefix(tiny, make_engine, layout):
    _, _, model, oracle = tiny
    kw = dict(max_slots=2, max_len=64, prefill_chunk=16, paged=layout != "dense")
    if layout == "paged-copy":
        kw["prefix_cache"] = PrefixCache(1 << 24)  # shared/external: restores by copy
    engine = make_engine(model, **kw)
    prompt = prompts([37], seed=5)[0]  # two full 16-token chunks restorable
    first = engine.submit(prompt, max_new_tokens=9).result(WAIT)
    again = engine.submit(prompt, max_new_tokens=9).result(WAIT)
    np.testing.assert_array_equal(first, oracle(prompt, 9))
    np.testing.assert_array_equal(again, first)
    s = engine.serving_metrics()
    assert s["prefix_cache_hit_chunks"] == 2
    assert s["prefix_alias_chunks"] == (2 if layout == "paged-alias" else 0)
    assert engine.cached_prefix_tokens(prompt) == 32
    steps = engine.compile_watcher.counts()
    assert ("restore" in steps) == (layout != "paged-alias")  # aliasing is host work


@pytest.mark.parametrize("async_ticks", [False, True], ids=["sync", "async"])
def test_forced_preemption_resumes_token_exactly(tiny, make_engine, async_ticks):
    _, _, model, oracle = tiny
    # 8 pages of 8 tokens for three streams of up to 34 tokens: the pool
    # runs dry mid-decode and the newest stream is preempted.
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=8, max_pages=8,
                         prefix_cache_mb=0, async_ticks=async_ticks)
    work = [(p, 20) for p in prompts((12, 14, 9), seed=7)]
    check_streams([engine.submit(p, max_new_tokens=n) for p, n in work], work, oracle)
    s = engine.serving_metrics()
    assert s["preemptions"] >= 1 and engine.page_pool_metrics()["preemptions"] >= 1
    assert s["pages_used_max"] <= 8


@pytest.mark.parametrize("async_ticks", [False, True], ids=["sync", "async"])
def test_failing_callback_fails_only_its_request(tiny, make_engine, async_ticks):
    _, _, model, oracle = tiny
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=16,
                         async_ticks=async_ticks)
    work = items(lengths=(5, 11, 19), seed=9)
    seen = []

    def bad(token):
        seen.append(token)
        if len(seen) == 3:
            raise ValueError("consumer broke")

    reqs = [engine.submit(work[0][0], max_new_tokens=12, on_token=bad)]
    reqs += [engine.submit(p, max_new_tokens=n) for p, n in work[1:]]
    assert reqs[0].wait(WAIT) and reqs[0].status is RequestStatus.FAILED
    assert isinstance(reqs[0].error, ValueError)
    with pytest.raises(RuntimeError, match="failed"):
        reqs[0].result(WAIT)
    check_streams(reqs[1:], work[1:], oracle)
    assert engine.healthy


# The JAX engine's thread raises from its CompileWatcher.stop() on this
# jax version (a private unregister hook it calls is gone); the engine has
# served and exited by then, so the warning says nothing about the port.
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_one_round_against_the_jax_engine(tiny, make_engine):
    module, params, model, oracle = tiny
    work = items(lengths=(3, 9, 17, 26, 33, 40), seed=11)
    jax_engine = JaxServingEngine(module, params, max_slots=3, max_len=64, prefill_chunk=16,
                                  cache_dtype=jnp.float32)
    try:
        jax_streams = [r.result(WAIT) for r in submit_staggered(jax_engine, work)]
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=16)
    port_streams = [r.result(WAIT) for r in submit_staggered(engine, work)]
    for (prompt, max_new), a, b in zip(work, jax_streams, port_streams):
        np.testing.assert_array_equal(b, np.asarray(a))
        np.testing.assert_array_equal(b, oracle(prompt, max_new))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_no_new_step_signature_after_warmup(tiny, make_engine, paged):
    _, _, model, oracle = tiny
    engine = make_engine(model, max_slots=3, max_len=64, prefill_chunk=16, paged=paged)
    watcher = engine.compile_watcher
    warm = watcher.counts()
    assert warm == ({"chunk": 1, "decode": 1} if paged
                    else {"chunk": 1, "decode": 1, "restore": 1})
    assert watcher.events == [] and watcher.summary()["graph_captures"] == 0
    assert engine.captured_steps == []  # no graphs on the CPU
    repeat = items(lengths=(37,), seed=5)
    check_streams([engine.submit(p, max_new_tokens=n) for p, n in repeat], repeat, oracle)
    # The repeat goes first: later arrivals may reclaim the alias cache's pages.
    work = repeat + items(lengths=tuple(range(1, 41, 3)), seed=13)
    check_streams(submit_staggered(engine, work, waves=4), work, oracle)
    assert engine.serving_metrics()["prefix_cache_hit_chunks"] >= 2
    assert watcher.events == [], f"new step signatures after warmup: {watcher.events}"
    assert watcher.counts() == warm


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slot_rows_forward_equals_batch_one_forwards(tiny, paged):
    """The cached forward at a tensor position per row (the engine's
    steps) gives each row what a batch-1 forward at its own int position
    gives it, over head-major slot rows or pages."""
    _, _, model, _ = tiny
    cfg = model.config
    rng = np.random.default_rng(17)
    starts = [0, 5, 19]
    B, S, L, P = len(starts), 4, 32, 8
    G, hd = cfg.num_key_value_heads, cfg.head_dim
    history = [torch.from_numpy(rng.integers(0, 256, (1, s + S))).long() for s in starts]
    with torch.inference_mode():
        want = []
        for h, s in zip(history, starts):
            cache = init_kv_cache(cfg, 1, L, torch.float32, device="cpu")
            if s:
                model(h[:, :s], cache=cache, cache_pos=0)
            want.append(model(h[:, s:], cache=cache, cache_pos=s)[0])
        # The same histories, written row by row into one batched state.
        if paged:
            n_pages = L // P
            pool = [{"k": torch.zeros(B * n_pages + 1, G, P, hd),
                     "v": torch.zeros(B * n_pages + 1, G, P, hd)}
                    for _ in range(cfg.num_hidden_layers)]
            table = 1 + torch.arange(B * n_pages).view(B, n_pages)
            for b, (h, s) in enumerate(zip(history, starts)):
                if s:
                    layers = [dict(c, table=table[b:b + 1]) for c in pool]
                    model(h[:, :s], cache=layers, cache_pos=torch.tensor([0]))
            layers = [dict(c, table=table) for c in pool]
        else:
            rows = [{"k": torch.zeros(B, G, L, hd), "v": torch.zeros(B, G, L, hd)}
                    for _ in range(cfg.num_hidden_layers)]
            for b, (h, s) in enumerate(zip(history, starts)):
                if s:
                    layers = [dict(c, rows=torch.tensor([b])) for c in rows]
                    model(h[:, :s], cache=layers, cache_pos=torch.tensor([0]))
            layers = rows
        ids = torch.cat([h[:, s:] for h, s in zip(history, starts)])
        got = model(ids, cache=layers, cache_pos=torch.tensor(starts))[0]
    for b in range(B):
        torch.testing.assert_close(got[b:b + 1], want[b], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("true_len, offset", [(5, 0), (16, 0), (17, 16), (20, 8), (3, 16), (40, 0)])
def test_chunk_prefill_token_reads_the_jax_row(true_len, offset):
    """``generation._chunk_prefill_token`` picks the row of ``true_len - 1``
    in the chunk window, clamped into it, as the JAX epilogue does (greedy,
    with an EOS id that latches ``done``), given tensors or ints."""
    import jax

    from accelerate_tpu.generation import _chunk_prefill_token as jax_epilogue
    from accelerate_tpu.generation import _make_selector as jax_selector
    from accelerate_tpu_torch.generation import _chunk_prefill_token
    from accelerate_tpu_torch.serving.engine import _make_keyed_selector

    logits = np.random.default_rng(true_len + offset).normal(size=(1, 16, 32)).astype(np.float32)
    eos = int(logits[0, min(max(true_len - 1 - offset, 0), 15)].argmax())
    want_tok, want_done, _ = jax_epilogue(jnp.asarray(logits), jax.random.PRNGKey(0),
                                          jax_selector(None), eos, jnp.int32, true_len, offset)
    select = _make_keyed_selector(None)
    for t, o in ((torch.tensor([true_len]), torch.tensor([offset])), (true_len, offset)):
        tok, done = _chunk_prefill_token(torch.from_numpy(logits), None, select, eos,
                                         torch.int64, t, o)
        assert tok.tolist() == np.asarray(want_tok).tolist()
        assert done.tolist() == np.asarray(want_done).tolist() == [True]
