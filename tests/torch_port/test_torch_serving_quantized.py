"""Quantized serving in the port against the JAX package, on the CPU:
int8 KV pages (one f32 scale per page and layer leaf) and int8 base weights
under full-precision LoRA adapters.

The page quantizer gives JAX's int8 page bit for bit and its scale within
1 ulp; an int8-KV engine's streams are token-exact with the JAX int8-KV
engine (f32 cache) and its pages dequantize within one quantum of JAX's.
``quantize_tensor`` (8 and 4 bits) gives JAX's integers after the layout
transpose. An int8-weight engine computes exactly what a full-precision
engine serving the dequantized weights computes (and the JAX int8-weight
engine), adapters included. A shared prefix cache never crosses KV dtypes;
int8 pages cost fewer bytes; no new step signature appears after warmup;
invalid combinations fail at construction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.utils.quantization import quantize_tensor as jax_quantize_tensor
from accelerate_tpu_torch import LlamaForCausalLM
from accelerate_tpu_torch.adapters import (
    AdapterBank,
    LoRAConfig,
    dequantized_state_dict,
    merge_adapter,
    quantize_base_weights,
)
from accelerate_tpu_torch.generation import generate
from accelerate_tpu_torch.serving import PrefixCache, ServingEngine
from accelerate_tpu_torch.serving.engine import _quant_page
from accelerate_tpu_torch.utils.convert import adapter_from_flax
from accelerate_tpu_torch.utils.quantization import (
    QuantizationConfig,
    dequantize_params,
    quantize_params,
    quantize_tensor,
    quantized_nbytes,
)
from torch_serving_common import WAIT, make_engine, pair, prompts  # noqa: F401

BASE = dict(max_slots=2, max_len=64, prefill_chunk=8, prefix_cache_mb=0.0)


@pytest.fixture(scope="module")
def tiny():
    return pair(seed=0)


def reference(model, prompt, max_new):
    out = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=max_new,
                   cache_dtype=torch.float32)
    return out[0, prompt.shape[1]:].numpy()


def work(seed=1):
    return [(p, 12) for p in prompts((5, 3, 12, 19), seed=seed)]


def run(engine, items, **kw):
    reqs = [engine.submit(p, max_new_tokens=n, ignore_eos=True, block=True, **kw)
            for p, n in items]
    return [np.asarray(r.result(WAIT)) for r in reqs]


def ulps(a, b):
    """Distance in f32 units in the last place."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def jax_dequantized_model(params, cfg):
    """A port model on the JAX package's dequantized int8 base weights."""
    from accelerate_tpu.adapters import quantize_base_weights as jax_quantize_base
    from accelerate_tpu.adapters.quantize import dequantize_params as jax_dequantize
    from accelerate_tpu_torch.utils.convert import state_dict_from_flax

    dq = jax_dequantize(jax_quantize_base(params), jnp.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, dq), cfg))
    return model.eval()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0, 0.0])
def test_quant_page_is_the_jax_page(scale):
    """The same f32 page block (token-major in JAX, head-major here): the
    int8 page bit for bit, the scale within 1 ulp (an all-zero block gets
    the 1e-6 floor in both)."""
    rng = np.random.default_rng(int(scale * 100) + 1)
    block = (scale * rng.standard_normal((8, 2, 16))).astype(np.float32)  # [P, G, hd]
    block[3, 1, 5] = 127.5 * scale / 127.0  # a value exactly between two steps
    q_jax, s_jax = JaxServingEngine._quant_page(None, jnp.asarray(block))
    q, s = _quant_page(torch.from_numpy(block.transpose(1, 0, 2))[None])  # [1, G, P, hd]
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(q_jax).transpose(1, 0, 2))
    assert ulps(s.numpy()[0], np.asarray(s_jax)) <= 1


@pytest.mark.parametrize("bits, shape", [(8, (48, 32)), (4, (64, 32)), (4, (48, 24)),
                                         (8, (3, 40, 16))])
def test_quantize_tensor_equals_jax(bits, shape):
    """``quantize_tensor`` on the torch layout [..., out, in] against the JAX
    one on the flax layout [..., in, out]: the same integers after the
    transpose, scales within 1 ulp, the same dequantized values."""
    rng = np.random.default_rng(bits + len(shape))
    kernel = rng.standard_normal(shape).astype(np.float32)  # flax [..., in, out]
    kernel[..., :, 2] = 0.0  # an all-zero output channel: scale 1 in both
    want = jax_quantize_tensor(jnp.asarray(kernel), bits=bits, block_size=16)
    got = quantize_tensor(torch.from_numpy(np.swapaxes(kernel, -1, -2).copy()), bits=bits,
                          block_size=16)
    np.testing.assert_array_equal(got.q.numpy(), np.swapaxes(np.asarray(want.q, np.int8), -1, -2))
    if bits == 8:  # JAX [..., 1, out], here [..., out, 1]
        jax_scale = np.swapaxes(np.asarray(want.scale), -1, -2)
    else:          # JAX [..., nb, 1, out], here [..., out, nb, 1]
        jax_scale = np.moveaxis(np.asarray(want.scale), -1, -3)
    assert np.max(ulps(got.scale.numpy(), jax_scale)) <= 1
    assert got.block_size == want.block_size
    np.testing.assert_allclose(got.dequantize(torch.float32).numpy(),
                               np.swapaxes(np.asarray(want.dequantize(jnp.float32)), -1, -2),
                               rtol=1e-6, atol=1e-7)
    assert got.nbytes() == want.nbytes()


def test_quantize_params_selects_like_the_jax_package(tiny):
    _, _, model = tiny
    cfg = QuantizationConfig(load_in_8bit=True, min_weight_size=256, skip_modules=["lm_head"])
    q = quantize_params(model.state_dict(), cfg)
    quantized = sorted(n for n, t in q.items() if hasattr(t, "bits"))
    # Every projection and the embedding (2-D, >= 256 elements); norms stay.
    assert quantized and all(n.endswith("weight") for n in quantized)
    assert "model.embed_tokens.weight" in quantized and "lm_head.weight" not in quantized
    assert not any("norm" in n for n in quantized)
    dense = dequantize_params(q, torch.float32)
    assert quantized_nbytes(q) < sum(t.numel() * 4 for t in dense.values())


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_int8_kv_streams_and_pages_equal_the_jax_engine(tiny, make_engine):
    module, params, model = tiny
    items = work()
    jax_engine = JaxServingEngine(module, params, **BASE, kv_dtype="int8",
                                  cache_dtype=jnp.float32, async_ticks=False)
    try:
        jax_streams = run(jax_engine, items)
        jax_pool = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(
            jax_engine._state["pool"])]
        jax_scales = np.asarray(jax_engine._state["pscale"])
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    engine = make_engine(model, **BASE, kv_dtype="int8", async_ticks=False)
    streams = run(engine, items)
    for a, b in zip(jax_streams, streams):
        np.testing.assert_array_equal(b, a)
    # Every page that held K/V (the same host page accounting, so the same
    # ids): dequantized within one quantum of JAX's.
    used = range(1, engine.page_pool_metrics()["page_allocations"] + 1)
    used = [p for p in used if p <= engine.total_pages]
    for i, (layer, leaf) in enumerate((layer, leaf) for layer in engine._kv for leaf in ("k", "v")):
        q = layer[leaf][used].float().numpy()                          # [n, G, P, hd]
        s = engine._pscale[i, used].numpy()[:, None, None, None]
        jq = jax_pool[i][used][:, 0].transpose(0, 2, 1, 3).astype(np.float32)
        js = jax_scales[i, used][:, None, None, None]
        assert np.all(np.abs(q * s - jq * js) <= np.maximum(s, js) * (1 + 1e-6)), i


def test_int8_kv_is_bounded_divergence_from_fp(tiny, make_engine):
    """Not exact (quantized K/V), but close at tiny widths: the int8 streams
    start as the fp engine's."""
    _, _, model = tiny
    items = work(seed=3)
    fp = run(make_engine(model, **BASE), items)
    q8 = run(make_engine(model, **BASE, kv_dtype="int8"), items)
    agreed = [int(np.argmax(a != b)) if np.any(a != b) else len(a) for a, b in zip(fp, q8)]
    assert min(agreed) >= 1 and sum(agreed) >= len(items) * 6, agreed


@pytest.mark.parametrize("mode", [dict(), dict(spec_lookup=2), dict(draft_model="self")],
                         ids=["decode", "lookup", "draft"])
def test_int8_kv_no_new_signature_after_warmup(tiny, make_engine, mode):
    _, _, model = tiny
    kw = {k: (model if v == "self" else v) for k, v in mode.items()}
    engine = make_engine(model, **BASE, kv_dtype="int8", **kw)
    warm = engine.compile_watcher.counts()
    items = work(seed=5)
    run(engine, items)
    run(engine, items[::-1])
    assert engine.compile_watcher.events == [] and engine.compile_watcher.counts() == warm
    if kw:
        assert engine.serving_metrics()["spec_ticks"] > 0


def test_int8_weights_equal_the_dequantized_fp_engine(tiny, make_engine):
    """``weights_dtype="int8"`` computes what the fp engine computes over the
    dequantized weights, token for token; the caller's model stays fp."""
    _, _, model = tiny
    qmodel = quantize_base_weights(model)
    dq = LlamaForCausalLM(model.config, device="cpu")
    dq.load_state_dict(dequantized_state_dict(qmodel))
    dq.eval()
    items = work()
    engine = make_engine(model, **BASE, weights_dtype="int8")
    assert engine.weights_dtype == "int8"
    for got, (p, n) in zip(run(engine, items), items):
        np.testing.assert_array_equal(got, reference(dq, p, n))
    assert type(model.model.layers[0].self_attn.q_proj).__name__ == "_Projection"
    assert type(engine.module.model.layers[0].self_attn.q_proj).__name__ == "QuantizedLinear"
    assert engine.module.model.embed_tokens.weight is model.model.embed_tokens.weight  # shared


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_int8_weights_equal_the_jax_int8_engine(tiny, make_engine):
    module, params, model = tiny
    items = work(seed=7)
    jax_engine = JaxServingEngine(module, params, **BASE, weights_dtype="int8",
                                  cache_dtype=jnp.float32, async_ticks=False)
    try:
        jax_streams = run(jax_engine, items)
    finally:
        jax_engine.shutdown(drain=False, timeout=WAIT)
    streams = run(make_engine(model, **BASE, weights_dtype="int8"), items)
    dq = jax_dequantized_model(params, model.config)
    for a, b, (p, n) in zip(jax_streams, streams, items):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, reference(dq, p, n))


def test_lora_stays_exact_on_quantized_base(tiny, make_engine):
    """Adapter requests on the int8 base equal generate on the merged
    adapter over the dequantized base; base requests (bank row 0) equal the
    dequantized base."""
    from accelerate_tpu.adapters import init_lora_params as jax_init_lora
    from accelerate_tpu.adapters import LoRAConfig as JaxLoRAConfig

    _, params, model = tiny
    adapter = adapter_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_init_lora(jax.random.PRNGKey(1), params, JaxLoRAConfig(rank=4))))
    for i, mod in enumerate(adapter.values()):  # a nonzero delta (init has b = 0)
        mod["b"] = 0.05 * torch.from_numpy(
            np.random.default_rng(i).standard_normal(tuple(mod["b"].shape)).astype(np.float32))
    bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=2)
    engine = make_engine(model, **BASE, weights_dtype="int8", adapters=bank)
    engine.register_adapter("a", adapter)
    qmodel = quantize_base_weights(model)
    dq = LlamaForCausalLM(model.config, device="cpu")
    dq.load_state_dict(dequantized_state_dict(qmodel))
    refs = {"a": merge_adapter(dq.eval(), adapter), None: dq}
    items = work(seed=9)
    for name in ("a", None):
        for got, (p, n) in zip(run(engine, items, adapter=name), items):
            np.testing.assert_array_equal(got, reference(refs[name], p, n), err_msg=str(name))


def test_shared_prefix_cache_never_crosses_kv_dtypes(tiny, make_engine):
    _, _, model = tiny
    prompt = np.arange(1, 18, dtype=np.int32)[None]  # two full 8-token chunks restorable
    shared = PrefixCache(8 * 2 ** 20)
    kw = {k: v for k, v in BASE.items() if k != "prefix_cache_mb"}
    fp = make_engine(model, prefix_cache=shared, **kw)
    q8 = make_engine(model, kv_dtype="int8", prefix_cache=shared, **kw)

    def hits(engine):
        return engine.serving_metrics()["prefix_cache_hit_chunks"]

    ref = reference(model, prompt, 8)
    a, b = (run(fp, [(prompt, 8)])[0] for _ in range(2))
    np.testing.assert_array_equal(a, ref)
    np.testing.assert_array_equal(b, ref)
    assert hits(fp) > 0
    c = run(q8, [(prompt, 8)])[0]
    assert hits(q8) == 0, "an fp prefix entry restored into an int8 pool"
    d = run(q8, [(prompt, 8)])[0]
    assert hits(q8) > 0
    np.testing.assert_array_equal(c, d)
    before = hits(fp)
    run(fp, [(prompt, 8)])
    assert hits(fp) > before


def test_int8_pool_bytes_shrink_and_report_dtype(tiny, make_engine):
    _, _, model = tiny
    fp = ServingEngine(model, device="cpu", autostart=False, **BASE)
    q8 = ServingEngine(model, device="cpu", autostart=False, kv_dtype="int8", **BASE)
    try:
        assert q8.kv_cache_per_chip_bytes() < fp.kv_cache_per_chip_bytes()
        assert q8._page_bytes < fp._page_bytes
        cfg = model.config
        elems = cfg.num_key_value_heads * 8 * cfg.head_dim
        assert q8._page_bytes == cfg.num_hidden_layers * 2 * (elems + 4)
        assert q8.page_pool_metrics()["kv_dtype"] == "int8"
        assert fp.page_pool_metrics()["kv_dtype"] is None
    finally:
        fp.shutdown()
        q8.shutdown()


def test_validation(tiny):
    _, _, model = tiny
    kw = dict(device="cpu", autostart=False, **BASE)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(model, kv_dtype="int4", **kw)
    with pytest.raises(ValueError, match="weights_dtype"):
        ServingEngine(model, weights_dtype="fp8", **kw)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, kv_dtype="int8", paged=False, **{k: v for k, v in kw.items()})
