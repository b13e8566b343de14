"""Multi-tenant LoRA adapters in the port, case for case with the JAX
package's ``tests/test_adapters.py``, on the CPU at tiny widths.

Adapters come from the JAX package (``init_lora_params``, with a nonzero
``b``) through ``utils.convert.adapter_from_flax``, so both sides apply the
same factors: the port's ``lora=`` forward (shared and per-row factors)
against the JAX one; the core (config, init, merge, pad, counts); training
that moves only the adapter, one AdamW step against the JAX package's; the adapter checkpoint; the bank (identity row
0, validation, subsets, LRU with pins, rows written in place); served
streams under mixed tenants token-exact with generate on each request's
merged weights (and with the JAX engine), base requests identical to a
bank-less engine; no new step signature across loads and evictions; a
prefix cache keyed by tenant; a full bank failing a request, not the
engine; the per-adapter counters."""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.adapters import LoRAConfig as JaxLoRAConfig
from accelerate_tpu.adapters import init_lora_params as jax_init_lora
from accelerate_tpu.adapters.lora import _get_path as jax_get_path
from accelerate_tpu.adapters.lora import adapter_module_paths as jax_module_paths
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.adapters import (
    AdapterBank,
    AdapterBankFull,
    LoRAConfig,
    UnknownAdapterError,
    adapter_module_paths,
    adapter_rank,
    adapter_spec,
    count_lora_params,
    init_lora_params,
    load_adapter,
    lora_delta,
    merge_adapter,
    pad_adapter,
    prepare_lora,
    save_adapter,
    target_paths,
)
from accelerate_tpu_torch.generation import generate
from accelerate_tpu_torch.serving import RequestStatus
from accelerate_tpu_torch.utils.convert import adapter_from_flax, adapter_to_flax
from torch_serving_common import WAIT, make_engine, pair, prompts, wait_until  # noqa: F401

EOS = 7
PROMPT = np.array([[3, 5, 2, 9, 11]], np.int32)


@pytest.fixture(scope="module")
def tiny():
    return pair(seed=0)


def jax_adapter(params, rank, seed):
    """A JAX adapter whose delta is NOT zero (fresh init has b = 0)."""
    ad = jax_init_lora(jax.random.PRNGKey(seed), params, JaxLoRAConfig(rank=rank))
    for i, dotted in enumerate(jax_module_paths(ad)):
        mod = jax_get_path(ad, dotted)
        k = jax.random.fold_in(jax.random.PRNGKey(seed + 997), i)
        mod["b"] = 0.05 * jax.random.normal(k, mod["b"].shape, mod["b"].dtype)
    return ad


def port_adapter(params, rank, seed):
    return adapter_from_flax(jax.tree_util.tree_map(np.asarray, jax_adapter(params, rank, seed)))


def offline(model, prompt, n, eos=EOS):
    out = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=n, eos_token_id=eos,
                   cache_dtype=torch.float32)
    return out[0, prompt.shape[1]:].numpy()


def assert_matches_offline(got, ref, n):
    got = np.asarray(got)
    np.testing.assert_array_equal(got, ref[:len(got)])
    if len(got) < n:
        assert got[-1] == EOS and np.all(ref[len(got):] == EOS), (got, ref)


# -- the model's lora= path against the JAX package ---------------------------

def test_lora_forward_equals_jax(tiny):
    module, params, model = tiny
    ad = jax_adapter(params, 4, seed=3)
    ids = np.array([[3, 5, 2, 9, 11, 4]], np.int32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids), lora=ad))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), lora=adapter_from_flax(
            jax.tree_util.tree_map(np.asarray, ad))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    base = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))
    assert np.abs(want - base).max() > 1e-3  # the adapter changes the output


def test_per_row_adapters_in_the_cached_path(tiny):
    """The serving steps' form: each row of a tensor-position cached forward
    under its own adapter (factors with a leading row dim) gives what a
    batch-1 forward under that adapter gives."""
    _, params, model = tiny
    cfg = model.config
    ads = [port_adapter(params, 4, seed=s) for s in (5, 6)]
    zero = {p: {k: torch.zeros_like(v) for k, v in m.items()} for p, m in ads[0].items()}
    rows = [ads[0], zero, ads[1]]
    stacked = {p: {k: torch.stack([r[p][k] for r in rows]) for k in ("a", "b", "scale")}
               for p in ads[0]}
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 6))).long()
    with torch.inference_mode():
        want = [model(ids[b:b + 1], lora=rows[b]) for b in range(3)]
        L, G, hd = 16, cfg.num_key_value_heads, cfg.head_dim
        cache = [{"k": torch.zeros(3, G, L, hd), "v": torch.zeros(3, G, L, hd)}
                 for _ in range(cfg.num_hidden_layers)]
        got, _ = model(ids, cache=cache, cache_pos=torch.zeros(3, dtype=torch.long), lora=stacked)
    for b in range(3):
        torch.testing.assert_close(got[b:b + 1], want[b], atol=1e-5, rtol=1e-5)


# -- core: config / init / merge / pad -----------------------------------------

def test_config_validation():
    with pytest.raises(ValueError):
        LoRAConfig(rank=0)
    with pytest.raises(ValueError):
        LoRAConfig(dropout=1.0)
    with pytest.raises(ValueError):
        LoRAConfig(target_modules=())
    assert LoRAConfig(rank=8, alpha=16.0).scale == 2.0


def test_init_shapes_and_zero_delta(tiny):
    _, params, model = tiny
    cfg = LoRAConfig(rank=4)
    ad = init_lora_params(torch.Generator().manual_seed(0), model, cfg)
    paths = adapter_module_paths(ad)
    assert paths == target_paths(model, cfg)
    # The JAX package adapts the same projections (its flax names).
    want = sorted(adapter_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_init_lora(jax.random.PRNGKey(0), params, JaxLoRAConfig(rank=4)))))
    assert paths == want
    assert adapter_rank(ad) == 4
    for dotted in paths:
        mod, lin = ad[dotted], model.get_submodule(dotted)
        assert tuple(mod["a"].shape) == (lin.in_features, 4)
        assert tuple(mod["b"].shape) == (4, lin.out_features)
        assert torch.all(mod["b"] == 0)
        x = torch.ones(2, lin.in_features)
        assert torch.all(lora_delta(x, mod) == 0)


def test_unmatched_targets_raise(tiny):
    with pytest.raises(ValueError, match="matched nothing"):
        target_paths(tiny[2], LoRAConfig(target_modules=("nope_proj",)))


def test_merge_matches_split_application(tiny):
    _, params, model = tiny
    ad = port_adapter(params, 4, seed=3)
    ids = torch.tensor([[3, 5, 2, 9, 11]])
    with torch.no_grad():
        merged = merge_adapter(model, ad)(ids)
        split = model(ids, lora=ad)
    torch.testing.assert_close(merged, split, atol=1e-4, rtol=1e-4)
    assert torch.equal(merged.argmax(-1), split.argmax(-1))
    # The state-dict form merges the same weights.
    sd = merge_adapter(model.state_dict(), ad)
    name = adapter_module_paths(ad)[0] + ".weight"
    torch.testing.assert_close(sd[name], merge_adapter(model, ad).state_dict()[name])


def test_pad_adapter_is_bit_exact(tiny):
    _, params, model = tiny
    ad = port_adapter(params, 4, seed=5)
    padded = pad_adapter(ad, 8)
    assert adapter_rank(padded) == 8
    ids = torch.tensor([[3, 5, 2, 9]])
    with torch.no_grad():
        assert torch.equal(model(ids, lora=ad), model(ids, lora=padded))
    with pytest.raises(ValueError, match="exceeds bank rank"):
        pad_adapter(padded, 4)


def test_count_lora_params(tiny):
    model = tiny[2]
    with torch.device("meta"):
        meta = LlamaForCausalLM(model.config, device="meta")
    n, nbytes = count_lora_params(meta, LoRAConfig(rank=8))
    expect = sum(model.get_submodule(p).in_features * 8 + 8 * model.get_submodule(p).out_features
                 for p in target_paths(model, LoRAConfig(rank=8)))
    assert (n, nbytes) == (expect, expect * 4)


# -- training split --------------------------------------------------------------

def test_masked_step_trains_only_adapter(tiny):
    _, params, model = tiny
    model = LlamaForCausalLM(model.config, device="cpu")
    model.load_state_dict(tiny[2].state_dict())
    state = prepare_lora(model, LoRAConfig(rank=4), generator=torch.Generator().manual_seed(1))
    opt = state.wrap_optimizer(functools.partial(torch.optim.AdamW, lr=1e-2))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    old = {p: {k: v.detach().clone() for k, v in m.items()} for p, m in state.adapter.items()}
    ids = torch.tensor([[3, 5, 2, 9, 11, 4]])
    loss = model(ids, lora=state.adapter).float().pow(2).mean()
    loss.backward()
    opt.step()
    assert all(not p.requires_grad for p in model.parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    moved = 0
    for p, mod in state.adapter.items():
        assert torch.equal(mod["scale"], old[p]["scale"])
        moved += not torch.equal(mod["b"], old[p]["b"])
    assert moved > 0


def test_adapter_step_follows_the_jax_step(tiny):
    """One AdamW step on the same nonzero adapter and ids through the JAX
    package's prepare_lora/wrap_optimizer (optax.masked) and the port's
    prepare_lora/wrap_optimizer: the adapter gradients agree, every adapter
    leaf agrees after the step (``scale`` unchanged), and the base is
    unchanged in both. The gradients are held at 1e-4 relative; the stepped
    leaves at 1e-5 relative plus a thousandth of a step (``1e-3 * lr``):
    Adam divides each entry by its own magnitude, so an entry whose gradient
    is near ``eps`` turns the packages' f32 rounding into a step fraction."""
    import dataclasses

    import optax

    from accelerate_tpu.adapters import prepare_lora as jax_prepare_lora

    module, params, _ = tiny
    lr, wd = 1e-2, 1e-4
    ids = np.array([[3, 5, 2, 9, 11, 4]], np.int32)
    ad = jax_adapter(params, 4, seed=21)

    ts = dataclasses.replace(jax_prepare_lora(module, params, JaxLoRAConfig(rank=4)), adapter=ad)
    tx = ts.wrap_optimizer(optax.adamw(lr, weight_decay=wd))
    train = ts.train_params()

    def loss_fn(train):
        logits = module.apply({"params": train["base"]}, jnp.asarray(ids), lora=train["lora"])
        return jnp.mean(jnp.square(logits.astype(jnp.float32)))

    grads = jax.grad(loss_fn)(train)
    updates, _ = tx.update(grads, tx.init(train), train)
    new = optax.apply_updates(train, updates)

    model = LlamaForCausalLM(tiny[2].config, device="cpu")
    model.load_state_dict(tiny[2].state_dict())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = prepare_lora(model, LoRAConfig(rank=4))
    start = adapter_from_flax(jax.tree_util.tree_map(np.asarray, ad))
    assert sorted(start) == sorted(state.adapter)
    with torch.no_grad():   # JAX's factors into prepare_lora's own leaves
        for dotted, mod in state.adapter.items():
            for k in ("a", "b", "scale"):
                mod[k].copy_(start[dotted][k])
    opt = state.wrap_optimizer(functools.partial(torch.optim.AdamW, lr=lr, weight_decay=wd))
    model(torch.from_numpy(ids).long(), lora=state.adapter).float().pow(2).mean().backward()
    got_grads = {p: {k: state.adapter[p][k].grad.clone() for k in ("a", "b")}
                 for p in state.adapter}
    opt.step()

    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
        assert p.grad is None, n
    for base_new, base_old in zip(jax.tree_util.tree_leaves(new["base"]),
                                  jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(base_new), np.asarray(base_old))
    to_port = lambda tree: adapter_from_flax(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    want_grads, want_new = to_port(grads["lora"]), to_port(new["lora"])
    assert sorted(want_new) == sorted(state.adapter) and len(want_new) > 0
    for dotted, mod in state.adapter.items():
        for k in ("a", "b"):
            want = want_grads[dotted][k].numpy()
            assert np.abs(want).max() > 0, (dotted, k)
            np.testing.assert_allclose(got_grads[dotted][k].numpy(), want,
                                       rtol=1e-4, atol=1e-4 * np.abs(want).max())
        for k in ("a", "b", "scale"):
            np.testing.assert_allclose(mod[k].detach().numpy(), want_new[dotted][k].numpy(),
                                       rtol=1e-5, atol=1e-3 * lr, err_msg=f"{dotted}.{k}")
        assert torch.equal(mod["scale"].detach(), start[dotted]["scale"])


# -- checkpoint round-trip -------------------------------------------------------

def test_save_load_round_trip(tiny, tmp_path):
    _, params, _ = tiny
    cfg = LoRAConfig(rank=4, alpha=8.0)
    ad = port_adapter(params, 4, seed=9)
    save_adapter(ad, tmp_path / "ad", config=cfg)
    loaded, meta = load_adapter(tmp_path / "ad")
    assert meta["rank"] == 4 and meta["alpha"] == 8.0
    assert sorted(meta["modules"]) == adapter_module_paths(ad)
    assert adapter_spec(loaded) == adapter_spec(ad)
    for p in ad:
        for k in ("a", "b", "scale"):
            assert torch.equal(loaded[p][k], ad[p][k])
    # And back to the JAX package's tree.
    tree = adapter_to_flax(loaded)
    assert sorted(jax_module_paths(tree)) == sorted(jax_module_paths(jax_adapter(params, 4, 9)))


def test_load_rejects_non_adapter_dir(tmp_path):
    with pytest.raises((FileNotFoundError, ValueError)):
        load_adapter(tmp_path / "nothing-here")


# -- bank residency --------------------------------------------------------------

def test_row0_reserved_and_capacity(tiny):
    model = tiny[2]
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    assert bank.capacity == 2
    with pytest.raises(ValueError, match=">= 2"):
        AdapterBank(model, max_adapters=1)
    for leaves in bank.stacks.values():
        assert torch.all(leaves["a"][0] == 0) and leaves["scale"][0] == 0


def test_register_validates(tiny):
    _, params, model = tiny
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    ad = port_adapter(params, 4, seed=1)
    bank.register("a", ad)
    with pytest.raises(ValueError, match="already registered"):
        bank.register("a", ad)
    bank.register("a", ad, allow_update=True)
    with pytest.raises(ValueError, match="> bank rank"):
        bank.register("big", port_adapter(params, 8, seed=2))
    with pytest.raises(ValueError, match="non-empty string"):
        bank.register("", ad)
    with pytest.raises(UnknownAdapterError):
        bank.check_known("ghost")
    with pytest.raises(UnknownAdapterError):
        bank.unregister("ghost")


def test_subset_target_adapter(tiny):
    model = tiny[2]
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    qa = init_lora_params(torch.Generator().manual_seed(0), model,
                          LoRAConfig(rank=2, target_modules=("q_proj",)))
    bank.register("q-only", qa)
    assert bank.acquire("q-only") == (1, False, None)
    bank.release("q-only")
    for p, leaves in bank.stacks.items():
        if not p.endswith("q_proj"):
            assert torch.all(leaves["a"][1] == 0) and torch.all(leaves["b"][1] == 0)


def test_lru_eviction_and_pins(tiny):
    _, params, model = tiny
    bank = AdapterBank(model, config=LoRAConfig(rank=2), max_adapters=3)
    for name in ("a", "b", "c"):
        bank.register(name, port_adapter(params, 2, seed=ord(name)))
    ra, _, _ = bank.acquire("a")
    rb, _, _ = bank.acquire("b")
    assert {ra, rb} == {1, 2}
    bank.release("a")
    bank.release("b")
    assert bank.acquire("c") == (ra, False, "a")
    assert bank.acquire("b") == (rb, True, None)
    with pytest.raises(AdapterBankFull):
        bank.acquire("a")
    bank.release("b")
    ra2, _, evicted = bank.acquire("a")
    assert ra2 == rb and evicted == "b"
    c = bank.counters()
    assert c["loads"] == 4 and c["evictions"] == 2
    with pytest.raises(RuntimeError, match="in-flight"):
        bank.unregister("a")


def test_row_write_loads_actual_bytes_in_place(tiny):
    """A row load writes the adapter's bytes into the bank's own tensors:
    their storage never changes (the engine's CUDA graphs read it)."""
    _, params, model = tiny
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    ptrs = {p: {k: v.data_ptr() for k, v in m.items()} for p, m in bank.stacks.items()}
    ad = port_adapter(params, 4, seed=11)
    bank.register("x", ad)
    row, _, _ = bank.acquire("x")
    for p in adapter_module_paths(ad):
        got = bank.stacks[p]
        assert torch.equal(got["a"][row], ad[p]["a"]) and torch.equal(got["b"][row], ad[p]["b"])
    assert {p: {k: v.data_ptr() for k, v in m.items()} for p, m in bank.stacks.items()} == ptrs


# -- served exactness ------------------------------------------------------------

N = 10


@pytest.fixture(scope="module")
def tenants(tiny):
    _, params, model = tiny
    ads = {"r4": port_adapter(params, 4, seed=21), "r8": port_adapter(params, 8, seed=22)}
    refs = {name: merge_adapter(model, ad) for name, ad in ads.items()}
    refs[None] = model
    return ads, refs


def bank_engine(make_engine, model, ads, **kw):
    bank = AdapterBank(model, config=LoRAConfig(rank=8), max_adapters=4)
    engine = make_engine(model, max_slots=3, max_len=64, eos_token_id=EOS, adapters=bank, **kw)
    for name, ad in ads.items():
        engine.register_adapter(name, ad)
    return engine


@pytest.mark.parametrize("layout", [dict(), dict(prefill_chunk=None)], ids=["paged", "monolithic"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_mixed_batch_matches_merged_offline(tiny, tenants, make_engine, mode, layout):
    """Base (row 0), a rank-4 and a rank-8 tenant share one batch; each
    stream equals its merged weights' stream: greedy ``generate``, or the
    same seed on a bank-less engine serving the merged model (draws are
    keyed by seed and position)."""
    model = tiny[2]
    ads, refs = tenants
    sampling = dict(do_sample=True, temperature=0.9, top_k=50) if mode == "sampled" else {}
    engine = bank_engine(make_engine, model, ads, **sampling, **layout)
    reqs = {}
    for i, name in enumerate([None, "r4", "r8"]):
        reqs[name] = engine.submit(PROMPT, max_new_tokens=N, seed=50 + i, adapter=name)
        time.sleep(0.01)
    outs = {}
    for i, (name, r) in enumerate(reqs.items()):
        got = r.result(WAIT)
        if mode == "greedy":
            ref = offline(refs[name], PROMPT, N)
        else:
            plain = make_engine(refs[name], max_slots=1, max_len=64, eos_token_id=EOS,
                                **sampling, **layout)
            ref = plain.submit(PROMPT, max_new_tokens=N, seed=50 + i).result(WAIT)
            ref = np.concatenate([ref, np.full(N - len(ref), EOS)])
        assert_matches_offline(got, ref, N)
        outs[name] = np.asarray(got)
    assert not np.array_equal(outs["r4"], outs["r8"])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_tenant_streams_equal_the_jax_engine(tiny, make_engine):
    from accelerate_tpu.adapters import AdapterBank as JaxAdapterBank

    module, params, model = tiny
    jax_ads = {"r4": jax_adapter(params, 4, seed=21), "r8": jax_adapter(params, 8, seed=22)}
    bank = JaxAdapterBank(params, config=JaxLoRAConfig(rank=8), max_adapters=4)
    jax_engine = JaxServingEngine(module, params, max_slots=3, max_len=64, eos_token_id=EOS,
                                  adapters=bank, cache_dtype=jnp.float32, async_ticks=False)
    try:
        for name, ad in jax_ads.items():
            jax_engine.register_adapter(name, ad)
        reqs = [jax_engine.submit(PROMPT, max_new_tokens=N, adapter=name)
                for name in (None, "r4", "r8")]
        want = [np.asarray(r.result(WAIT)) for r in reqs]
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    ads = {k: adapter_from_flax(jax.tree_util.tree_map(np.asarray, v)) for k, v in jax_ads.items()}
    engine = bank_engine(make_engine, model, ads, async_ticks=False)
    got = [engine.submit(PROMPT, max_new_tokens=N, adapter=name).result(WAIT)
           for name in (None, "r4", "r8")]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_base_identical_to_bankless_engine(tiny, tenants, make_engine):
    model = tiny[2]
    prompt = np.array([[8, 6, 4, 2, 10]], np.int32)
    a = bank_engine(make_engine, model, tenants[0]).submit(prompt, max_new_tokens=N).result(WAIT)
    b = make_engine(model, max_slots=2, max_len=64, eos_token_id=EOS).submit(
        prompt, max_new_tokens=N).result(WAIT)
    np.testing.assert_array_equal(a, b)


def test_unknown_adapter_rejected_at_submit(tiny, tenants, make_engine):
    engine = bank_engine(make_engine, tiny[2], tenants[0])
    with pytest.raises(UnknownAdapterError):
        engine.submit(np.array([[1, 2]], np.int32), max_new_tokens=2, adapter="ghost")


def test_adapter_requires_bank(tiny, make_engine):
    engine = make_engine(tiny[2], max_slots=2, max_len=64, warmup=False)
    with pytest.raises(ValueError, match="AdapterBank"):
        engine.submit(np.array([[1, 2]], np.int32), max_new_tokens=2, adapter="x")
    with pytest.raises(RuntimeError, match="no adapter bank"):
        engine.register_adapter("x", {})
    assert not engine.adapter_resident("x")


def test_adapter_spec_matches_nonspec(tiny, make_engine):
    """A tenant's speculative stream equals its non-speculative one: the
    verify gathers the slot's adapter row, the draft stays base-weight."""
    _, params, model = tiny
    ad = port_adapter(params, 4, seed=1)
    streams = []
    for spec in (dict(draft_model=model, spec_tokens=4), dict(spec_lookup=2), dict()):
        bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=2)
        engine = make_engine(model, max_slots=3, max_len=64, eos_token_id=EOS, prefill_chunk=8,
                             adapters=bank, **spec)
        engine.register_adapter("t1", ad)
        streams.append([engine.submit(p, max_new_tokens=16, adapter=name).result(WAIT)
                        for p in prompts((5, 12), seed=3) for name in ("t1", None)])
    for spec_streams in streams[:2]:
        for a, b in zip(spec_streams, streams[2]):
            np.testing.assert_array_equal(a, b)


# -- no new step signature across hot loads and evictions -------------------------

def test_load_evict_mid_serve_captures_nothing(tiny, make_engine):
    _, params, model = tiny
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    engine = make_engine(model, max_slots=2, max_len=64, eos_token_id=EOS, prefill_chunk=16,
                         prefix_cache_mb=4.0, adapters=bank)
    engine.register_adapter("a", port_adapter(params, 4, seed=31))
    engine.register_adapter("b", port_adapter(params, 4, seed=32))
    warm = engine.compile_watcher.counts()
    prompt = np.array([[3, 5, 2, 9]], np.int32)
    for name in ("a", "b"):
        engine.submit(prompt, max_new_tokens=4, adapter=name).result(WAIT)
    engine.register_adapter("c", port_adapter(params, 4, seed=33))
    for name in ("c", "a", None, "b"):
        engine.submit(prompt, max_new_tokens=4, adapter=name).result(WAIT)
    assert engine.compile_watcher.events == [] and engine.compile_watcher.counts() == warm
    assert bank.counters()["evictions"] >= 1


# -- prefix-cache tenant isolation --------------------------------------------------

@pytest.mark.parametrize("layout", ["alias", "copy"])
def test_warm_prefix_does_not_cross_tenants(tiny, make_engine, layout):
    from accelerate_tpu_torch.serving import PrefixCache

    _, params, model = tiny
    ads = {"A": port_adapter(params, 4, seed=41), "B": port_adapter(params, 4, seed=42)}
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    cache = dict(prefix_cache_mb=8.0) if layout == "alias" else dict(
        prefix_cache=PrefixCache(8 << 20))
    engine = make_engine(model, max_slots=2, max_len=96, eos_token_id=EOS, prefill_chunk=8,
                         adapters=bank, **cache)
    for name, ad in ads.items():
        engine.register_adapter(name, ad)
    prompt = np.arange(1, 25, dtype=np.int32)[None, :]  # 3 full chunks
    refs = {name: merge_adapter(model, ad) for name, ad in ads.items()}
    refs[None] = model

    def run(adapter):
        before = engine.serving_metrics()["prefix_cache_hit_chunks"]
        got = engine.submit(prompt, max_new_tokens=6, adapter=adapter).result(WAIT)
        assert_matches_offline(got, offline(refs[adapter], prompt, 6), 6)
        return engine.serving_metrics()["prefix_cache_hit_chunks"] - before

    assert run("A") == 0
    assert run("B") == 0     # A's K/V must not reach B
    assert run(None) == 0    # nor the base model
    assert run("A") > 0
    assert run("B") > 0
    assert run(None) > 0
    assert engine.cached_prefix_tokens(prompt, adapter="A") > 0


# -- bank pressure -------------------------------------------------------------------

class SlowLlama(LlamaForCausalLM):
    def forward(self, *args, **kwargs):
        time.sleep(0.01)
        return super().forward(*args, **kwargs)


def test_bank_full_fails_request_not_engine(tiny, make_engine):
    _, params, model = tiny
    slow = SlowLlama(LlamaConfig.tiny(), device="cpu")
    slow.load_state_dict(model.state_dict())
    slow.eval()
    bank = AdapterBank(slow, config=LoRAConfig(rank=2), max_adapters=2)
    engine = make_engine(slow, max_slots=2, max_len=64, adapters=bank)
    engine.register_adapter("a", port_adapter(params, 2, seed=51))
    engine.register_adapter("b", port_adapter(params, 2, seed=52))
    prompt = np.array([[3, 5, 2]], np.int32)
    long = engine.submit(prompt, max_new_tokens=24, adapter="a", ignore_eos=True)
    wait_until(lambda: long.tokens, what="the long stream's first token")
    blocked = engine.submit(prompt, max_new_tokens=4, adapter="b")
    assert blocked.wait(WAIT) and blocked.status is RequestStatus.FAILED
    assert isinstance(blocked.error, AdapterBankFull)
    assert engine.healthy and engine.error is None
    assert len(long.result(WAIT)) == 24
    assert engine.adapter_resident("a") and not engine.adapter_resident("b")


# -- per-adapter metrics ---------------------------------------------------------------

def test_per_adapter_counters_flow_to_summary(tiny, make_engine):
    _, params, model = tiny
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    engine = make_engine(model, max_slots=2, max_len=64, eos_token_id=EOS, adapters=bank)
    engine.register_adapter("x", port_adapter(params, 4, seed=61))
    for _ in range(2):
        engine.submit(PROMPT[:, :4], max_new_tokens=4, adapter="x", ignore_eos=True).result(WAIT)
    s = engine.serving_metrics()
    assert s["adapter/x/requests"] == 2 and s["adapter/x/tokens"] == 8
    assert s["adapter/x/loads"] == 1 and s["adapter/x/hits"] == 1
    assert s["adapter_requests"] == 2 and s["adapters_tracked"] == 1
    assert engine.stats.per_adapter()["x"]["requests"] == 2
    assert all(np.isscalar(v) for v in s.values())
