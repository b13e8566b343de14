"""Big-model inference of the port held against the JAX package on the CPU.

One HF-layout directory, written from seeded weights by the JAX package's
own exporter, is loaded by both packages' ``load_hf_checkpoint_and_dispatch``
over every tier: all on the card (here: the execution device, the CPU), all
in host memory, all on disk (lazy references into the shards), disk through
memmap copies, a mixed map, and the solver's ``"auto"`` map. Tolerances:
streamed logits within 2e-5 (atol and rtol) of the JAX ``StreamedModel``'s
at f32 (einsum attention on both sides; the rest is summation order), and
bit-equal to the port's resident model (the same ops in the same order);
greedy, prompt-lookup and assisted decoding token-exact with the JAX
streamed decoders and with plain greedy. Sampled decoding draws from a
``torch.Generator``, so it is held to seed-determinism within the port.
T5 (transformers' tiny model written as an HF directory): the staged
streamed forward on the host and disk tiers equals the resident model's
logits bit for bit (and transformers' within 1e-5), streamed decoding
cached and uncached equals the resident ``seq2seq_generate`` and the JAX
``StreamedModel.seq2seq_generate`` up to its first EOS, and int8 loading
off the directory matches the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.utils import offload as joff
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch import (
    LlamaForCausalLM,
    QuantizationConfig,
    QuantizedTensor,
    block_specs_for,
    cpu_offload,
    cpu_offload_with_hook,
    disk_offload,
    dispatch_model,
    generate,
    init_empty_weights,
    init_on_device,
    load_and_quantize_hf_checkpoint,
    load_and_quantize_model,
    load_checkpoint_and_dispatch,
    load_checkpoint_in_model,
    load_hf_checkpoint_and_dispatch,
    save_model,
)
from accelerate_tpu_torch import big_modeling as pbm
from accelerate_tpu_torch.utils.convert import state_dict_from_flax
from accelerate_tpu_torch.utils.modeling import compute_module_sizes

from torch_big_model_common import hf_t5, jax_name, jax_params, write_hf_dir

TOL = dict(atol=2e-5, rtol=2e-5)
CPU = "cpu"

# Port map -> the JAX package's spelling of the same map.
MIXED = {"model.embed_tokens": 0, "model.layers.0": "cpu", "model.layers.1": "disk",
         "model.norm": 0, "lm_head": 0}
TIERS = {"card": {"": 0}, "host": {"": "cpu"}, "disk": {"": "disk"}, "mixed": MIXED}


def jax_map(device_map):
    return {jax_name(k) if k else k: v for k, v in device_map.items()}


class Checkpoint:
    """One family's weights, its HF directory and the port's resident model."""

    def __init__(self, root, family="llama", **overrides):
        self.cfg, self.jcfg, self.module, self.params = jax_params(family, **overrides)
        self.family = family
        self.dir = write_hf_dir(root / family, self.params, family, self.cfg)
        self.model = LlamaForCausalLM(self.cfg, device=CPU).eval()
        self.model.load_state_dict(state_dict_from_flax(self.params, self.cfg))
        self._jax, self._port = {}, {}

    def jax(self, tier, device_map=None, **kw):
        if tier not in self._jax:
            self._jax[tier], _ = jbm.load_hf_checkpoint_and_dispatch(
                self.dir, device_map=jax_map(device_map or TIERS[tier]), dtype=np.float32, **kw)
        return self._jax[tier]

    def port(self, tier, device_map=None, **kw):
        if tier not in self._port:
            self._port[tier], _ = load_hf_checkpoint_and_dispatch(
                self.dir, device_map=device_map or TIERS[tier], execution_device=CPU, **kw)
        return self._port[tier]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return Checkpoint(tmp_path_factory.mktemp("llama"))


def ids_for(B, S, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def repeating_prompt(seed=2, period=5, repeats=4, vocab=256):
    return np.tile(ids_for(1, period, seed, vocab), (1, repeats))


def jax_generate(streamed, ids, new, **kw):
    return np.asarray(streamed.generate(jnp.asarray(ids), max_new_tokens=new,
                                        cache_dtype=jnp.float32, **kw))


def port_generate(streamed, ids, new, **kw):
    return streamed.generate(torch.as_tensor(ids), max_new_tokens=new,
                             cache_dtype=torch.float32, **kw).numpy()


@pytest.mark.parametrize("tier", list(TIERS))
def test_streamed_logits_match_jax_and_the_resident_model(ckpt, tier):
    ids = ids_for(2, 16)
    ref = np.asarray(ckpt.jax(tier)(jnp.asarray(ids)))
    streamed = ckpt.port(tier)
    got = streamed(torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    with torch.inference_mode():
        assert torch.equal(got, ckpt.model(torch.as_tensor(ids)))
    lazy = {n for n, v in streamed.store.entries.items() if isinstance(v, pbm.LazyWeight)}
    on_disk = {n for n, p in streamed.store.placement.items() if p == "disk"}
    assert lazy == on_disk


@pytest.mark.parametrize("tier", list(TIERS))
def test_streamed_greedy_generate_matches_jax(ckpt, tier):
    ids = ids_for(1, 9, seed=4)
    ref = jax_generate(ckpt.jax(tier), ids, 12)
    got = port_generate(ckpt.port(tier), ids, 12)
    np.testing.assert_array_equal(got, ref)
    resident = generate(ckpt.model, torch.as_tensor(ids), 12, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, resident.numpy())


def test_auto_map_equals_the_jax_solver_and_streams(ckpt):
    with init_empty_weights():
        meta = LlamaForCausalLM(ckpt.cfg)
    sizes = compute_module_sizes(meta)
    budget = {0: sizes["lm_head"] + sizes["model.embed_tokens"] + sizes["model.layers.0"],
              "cpu": sizes["model.layers.1"] // 2}
    ours = pbm.infer_auto_device_map(meta, max_memory=budget)
    ref = jbm.infer_auto_device_map(jbm.init_empty_weights(ckpt.module), max_memory=budget)
    assert [(jax_name(k), v) for k, v in ours.items()] == list(ref.items())
    assert set(ours.values()) == {0, "cpu", "disk"}
    js, _ = jbm.load_hf_checkpoint_and_dispatch(ckpt.dir, device_map="auto", max_memory=budget,
                                                dtype=np.float32)
    ps, _ = load_hf_checkpoint_and_dispatch(ckpt.dir, device_map="auto", max_memory=budget,
                                            execution_device=CPU)
    assert {n: p for n, p in ps.store.placement.items()} == {
        n: pbm._placement_for(n, ours) for n in ps.store.placement}
    ids = ids_for(2, 16, seed=5)
    np.testing.assert_allclose(ps(torch.as_tensor(ids)).numpy(),
                               np.asarray(js(jnp.asarray(ids))), **TOL)
    np.testing.assert_array_equal(port_generate(ps, ids[:1], 8), jax_generate(js, ids[:1], 8))


def test_memmap_disk_tier_matches_jax(ckpt, tmp_path):
    ids = ids_for(2, 16, seed=6)
    js, _ = jbm.load_hf_checkpoint_and_dispatch(ckpt.dir, device_map={"": "disk"},
                                                dtype=np.float32,
                                                offload_folder=str(tmp_path / "jax"),
                                                offload_to_memmap=True)
    ps, _ = load_hf_checkpoint_and_dispatch(ckpt.dir, device_map={"": "disk"},
                                            offload_folder=str(tmp_path / "port"),
                                            offload_to_memmap=True, execution_device=CPU)
    assert all(v.memmap_info is not None for v in ps.store.entries.values())
    np.testing.assert_allclose(ps(torch.as_tensor(ids)).numpy(),
                               np.asarray(js(jnp.asarray(ids))), **TOL)
    # Each package reads the other's folder.
    jindex, pindex = (joff.load_offload_index(str(tmp_path / d)) for d in ("jax", "port"))
    name = "model.layers.0.self_attn.q_proj.weight"
    theirs = np.asarray(joff.load_offloaded_weight(str(tmp_path / "port" / f"{name}.dat"),
                                                   pindex[name]))
    np.testing.assert_array_equal(theirs, ckpt.model.state_dict()[name].numpy())
    ours = pbm.LazyWeight(str(tmp_path / "jax" / "model.layers_0.self_attn.q_proj.kernel.dat"),
                          name, memmap_info=jindex["model.layers_0.self_attn.q_proj.kernel"]).load()
    assert torch.equal(ours.T, ckpt.model.state_dict()[name])


def test_prompt_lookup_and_assistant_match_jax_and_greedy(ckpt):
    _, _, dmodule, dparams = jax_params("llama", seed=11, num_hidden_layers=1)
    draft = LlamaForCausalLM(dataclasses.replace(ckpt.cfg, num_hidden_layers=1), device=CPU)
    draft.load_state_dict(state_dict_from_flax(dparams, draft.config))
    ids = repeating_prompt()
    js, ps = ckpt.jax("mixed"), ckpt.port("mixed")
    greedy = port_generate(ps, ids, 14)
    np.testing.assert_array_equal(greedy, jax_generate(js, ids, 14))
    lookup = port_generate(ps, ids, 14, prompt_lookup_num_tokens=4)
    np.testing.assert_array_equal(lookup, greedy)
    np.testing.assert_array_equal(lookup, jax_generate(js, ids, 14, prompt_lookup_num_tokens=4))
    assisted = port_generate(ps, ids, 14, assistant_model=draft, num_draft=3)
    np.testing.assert_array_equal(assisted, greedy)
    np.testing.assert_array_equal(
        assisted, jax_generate(js, ids, 14, assistant_module=dmodule, assistant_params=dparams,
                               num_draft=3))


def test_speculation_streams_fewer_passes_than_tokens(ckpt):
    ps = ckpt.port("host")
    ids = torch.as_tensor(repeating_prompt(seed=3, period=4, repeats=6))
    warm = ps.generate(ids, max_new_tokens=24, cache_dtype=torch.float32)
    prompt = warm[:, :30]
    passes = {"n": 0}
    run = ps._run

    def counting(step, *specs):
        passes["n"] += 1
        return run(step, *specs)

    ps._run = counting
    try:
        plain = ps.generate(prompt, max_new_tokens=12, cache_dtype=torch.float32)
        plain_passes, passes["n"] = passes["n"], 0
        spec = ps.generate(prompt, max_new_tokens=12, cache_dtype=torch.float32,
                           prompt_lookup_num_tokens=4)
    finally:
        del ps._run
    assert torch.equal(spec, plain)
    assert plain_passes == 12 and passes["n"] <= plain_passes


def test_eos_uncached_and_sampled_decoding(ckpt):
    ps = ckpt.port("disk")
    ids = torch.as_tensor(ids_for(1, 9, seed=7))
    free = ps.generate(ids, max_new_tokens=10, cache_dtype=torch.float32)
    eos = int(free[0, -3])
    with_eos = ps.generate(ids, max_new_tokens=10, eos_token_id=eos, cache_dtype=torch.float32)
    assert torch.equal(with_eos, generate(ckpt.model, ids, 10, eos_token_id=eos,
                                          cache_dtype=torch.float32))
    assert torch.equal(ps.generate(ids, max_new_tokens=10, eos_token_id=eos, use_cache=False),
                       with_eos)
    kw = dict(max_new_tokens=10, do_sample=True, temperature=0.9, top_k=16,
              cache_dtype=torch.float32)
    a = ps.generate(ids, generator=torch.Generator().manual_seed(7), **kw)
    b = ps.generate(ids, generator=torch.Generator().manual_seed(7), **kw)
    assert torch.equal(a, b)
    cold = ps.generate(ids, max_new_tokens=10, do_sample=True, temperature=1e-6,
                       cache_dtype=torch.float32, prompt_lookup_num_tokens=3)
    assert torch.equal(cold, free)
    with pytest.raises(ValueError, match="mutually"):
        ps.generate(ids, max_new_tokens=4, assistant_model=ckpt.model, prompt_lookup_num_tokens=3)
    with pytest.raises(ValueError, match="KV cache"):
        ps.generate(ids, max_new_tokens=4, use_cache=False, prompt_lookup_num_tokens=3)


@pytest.mark.parametrize("family", ["mistral", "qwen2", "gemma2"])
def test_family_streams_match_jax(tmp_path, family):
    ck = Checkpoint(tmp_path, family)
    mixed = {"model.embed_tokens": "cpu", "model.layers.0": 0, "model.layers.1": "disk",
             "model.norm": "disk", "lm_head": "cpu"}
    js, ps = ck.jax("mixed", mixed), ck.port("mixed", mixed)
    ids = ids_for(2, 16, seed=8)
    np.testing.assert_allclose(ps(torch.as_tensor(ids)).numpy(),
                               np.asarray(js(jnp.asarray(ids))), **TOL)
    prompt = ids_for(1, 10, seed=9)
    np.testing.assert_array_equal(port_generate(ps, prompt, 10), jax_generate(js, prompt, 10))
    np.testing.assert_array_equal(port_generate(ps, prompt, 10, prompt_lookup_num_tokens=3),
                                  jax_generate(js, prompt, 10))


def test_block_specs_cover_every_parameter_and_share_modules(tmp_path):
    cfg, _, _, _ = jax_params("gemma2")
    with init_empty_weights():
        meta = LlamaForCausalLM(cfg)
    specs = block_specs_for(meta)
    names = set(dict(meta.named_parameters()))
    covered = {n for s in specs for p in s.prefixes for n in names
               if n == p or n.startswith(p + ".")}
    assert covered == names
    assert [s.kind for s in specs] == ["embed", "layer_w8", "layer", "head"]
    assert specs[-1].prefixes == ("model.norm", "model.embed_tokens")  # a tied head


def test_dispatch_cpu_offload_and_the_hook(ckpt, tmp_path):
    ids = torch.as_tensor(ids_for(2, 16, seed=10))
    with torch.inference_mode():
        ref = ckpt.model(ids)
    state = ckpt.model.state_dict()
    on_card = dispatch_model(ckpt.model, params=state, device_map={"model.layers.1": "cpu", "": 0},
                             execution_device=CPU)
    assert torch.equal(on_card(ids), ref)
    assert set(on_card._resident_cache) == {"embed", "layers.0", "head"}
    assert on_card.hbm_resident_bytes == sum(
        t.numel() * 4 for n, t in state.items() if not n.startswith("model.layers.1."))
    streamed, hook = cpu_offload_with_hook(ckpt.model, execution_device=CPU)
    assert torch.equal(streamed(ids), ref) and streamed.hbm_resident_bytes == 0
    streamed.prefetch = False  # each block fetched when it runs, on this thread
    assert torch.equal(streamed(ids), ref)
    hook.offload()
    assert streamed._pool is None and not streamed._resident_cache
    second, _ = cpu_offload_with_hook(ckpt.model, execution_device=CPU, prev_module_hook=hook)
    assert torch.equal(second(ids), ref)
    assert torch.equal(cpu_offload(ckpt.model, execution_device=CPU)(ids), ref)
    on_card.close()
    assert on_card.hbm_resident_bytes == 0 and not on_card._resident_cache
    with pytest.raises(ValueError, match="cannot disk-offload"):
        dispatch_model(ckpt.model, params=state, device_map={"": "disk"}, execution_device=CPU)
    with init_empty_weights():
        meta = LlamaForCausalLM(ckpt.cfg)
    with pytest.raises(ValueError, match="meta device"):
        dispatch_model(meta, execution_device=CPU)


def test_disk_offload_and_checkpoint_loading(ckpt, tmp_path):
    ids = torch.as_tensor(ids_for(2, 16, seed=12))
    with torch.inference_mode():
        ref = ckpt.model(ids)
    save_model(None, ckpt.model, str(tmp_path / "port"), max_shard_size="200KB")
    with init_empty_weights():
        meta = LlamaForCausalLM(ckpt.cfg)
    lazy = disk_offload(meta, str(tmp_path / "port"), execution_device=CPU)
    assert torch.equal(lazy(ids), ref)
    copies = disk_offload(meta, str(tmp_path / "port"), offload_folder=str(tmp_path / "off"),
                          execution_device=CPU)
    assert (tmp_path / "off" / "index.json").exists()
    assert torch.equal(copies(ids), ref)
    store = load_checkpoint_in_model(meta, str(tmp_path / "port"), MIXED, dtype=torch.float16,
                                     execution_device=CPU)
    assert {n for n, v in store.entries.items() if isinstance(v, pbm.LazyWeight)} == {
        n for n in store.entries if n.startswith("model.layers.1.")}
    assert all(v.dtype == torch.float16 for v in store.entries.values()
               if not isinstance(v, pbm.LazyWeight))
    half = load_checkpoint_and_dispatch(meta, str(tmp_path / "port"), device_map=MIXED,
                                        dtype=torch.float16, execution_device=CPU)
    got = half(ids)  # every weight fp16, so fp16 logits: within 3e-2 of f32's
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(), ref, atol=3e-2, rtol=3e-2)
    save_model(None, torch.nn.ModuleDict({"model": torch.nn.ModuleDict(
        {"norm": ckpt.model.model.norm})}), str(tmp_path / "partial"))
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint_in_model(meta, str(tmp_path / "partial"), {"": 0}, execution_device=CPU)


def test_entry_points_raise_without_a_card(ckpt):
    with init_empty_weights():
        meta = LlamaForCausalLM(ckpt.cfg)
    assert next(meta.parameters()).is_meta
    with init_on_device("meta"):
        assert torch.empty(2).is_meta
    calls = [
        lambda: load_hf_checkpoint_and_dispatch(ckpt.dir, device_map={"": "cpu"}),
        lambda: load_checkpoint_in_model(meta, ckpt.dir, {"": "disk"}),
        lambda: dispatch_model(ckpt.model, device_map={"": "cpu"}),
        lambda: cpu_offload(ckpt.model),
        lambda: disk_offload(meta, ckpt.dir),
        lambda: load_and_quantize_hf_checkpoint(ckpt.dir, QuantizationConfig(load_in_8bit=True)),
        lambda: LlamaForCausalLM(ckpt.cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unpinned_host_weights_refuse_a_card_copy(ckpt):
    streamed = dispatch_model(ckpt.model, device_map={"": "cpu"}, execution_device=CPU)
    streamed._cuda = True  # as on a card: the host tensors here are not pinned
    with pytest.raises(RuntimeError, match="not pinned"):
        streamed._fetch(streamed.specs[1])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_loading_matches_jax(ckpt, bits):
    """Dequantized weights equal the JAX package's (transposed) exactly;
    logits through the dequantized f32 weights within 1e-4."""
    kw = {"load_in_8bit": True} if bits == 8 else {"load_in_4bit": True, "block_size": 32}
    _, _, jqp, japply = jq.load_and_quantize_hf_checkpoint(
        ckpt.dir, jq.QuantizationConfig(compute_dtype=jnp.float32, **kw))
    qcfg = QuantizationConfig(compute_dtype=torch.float32, **kw)
    cfg, module, qp, apply = load_and_quantize_hf_checkpoint(ckpt.dir, qcfg, device=CPU)
    assert cfg == ckpt.cfg and next(module.parameters()).is_meta
    quantized = [n for n, t in qp.items() if isinstance(t, QuantizedTensor)]
    assert "model.layers.0.self_attn.q_proj.weight" in quantized and "lm_head.weight" not in quantized
    for name in quantized:
        node = jqp
        for part in jax_name(name).split("."):
            node = node[part]
        want = np.asarray(node.dequantize(jnp.float32))
        want = want if name.endswith("embed_tokens.weight") else want.T
        np.testing.assert_array_equal(qp[name].dequantize(torch.float32).numpy(), want)
    ids = ids_for(2, 12, seed=13)
    with torch.inference_mode():
        got = apply(qp, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(japply(jqp, jnp.asarray(ids))), atol=1e-4,
                               rtol=1e-4)
    from_params, _ = load_and_quantize_model(module, params=ckpt.model.state_dict(),
                                             quantization_config=qcfg, device=CPU)
    for name in quantized:
        assert torch.equal(from_params[name].q, qp[name].q)
    with pytest.raises(ValueError, match="exactly one"):
        load_and_quantize_model(module, quantization_config=qcfg, device=CPU)


# -- T5: the encoder-decoder streamed --------------------------------------


def t5_hf_dir(tmp_path, variant="relu-tied"):
    """transformers' tiny T5 written as an HF directory; returns the
    transformers model."""
    import json

    hf = hf_t5(variant)
    save_file({k: v.numpy() for k, v in hf.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf.config.to_dict()))
    return hf


def t5_resident(directory):
    from accelerate_tpu_torch.utils.hf_interop import load_hf_checkpoint, model_from_config

    cfg, state = load_hf_checkpoint(directory)
    model = model_from_config(cfg, "t5", device=CPU)
    model.load_state_dict(state)
    return model


def t5_src(B=2, S=8):
    return torch.from_numpy((np.arange(B * S).reshape(B, S) * 7) % 100)


@pytest.mark.parametrize("tier", ["cpu", "disk"])
def test_t5_streamed_forward_matches_the_resident_model(tmp_path, tier):
    """The stages in order give transformers' logits (1e-5), and the
    resident model's bit for bit."""
    hf = t5_hf_dir(tmp_path, "flan")
    streamed, meta = load_hf_checkpoint_and_dispatch(str(tmp_path), device_map={"": tier},
                                                     execution_device=CPU)
    assert next(meta.parameters()).is_meta
    assert [s.stage for s in streamed.specs].count("enc") == 4  # embed, 2 layers, norm
    src, tgt = t5_src(), t5_src(S=6) // 2
    got = streamed(src, tgt)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), hf(input_ids=src, decoder_input_ids=tgt)
                                   .logits.numpy(), atol=1e-5, rtol=1e-5)
        assert torch.equal(got, t5_resident(str(tmp_path))(src, tgt))


@pytest.mark.parametrize("variant", ["relu-tied", "flan"])
def test_t5_streamed_decoding_is_token_exact(tmp_path, variant):
    """On the host tier: the cached streamed decode equals the resident
    ``seq2seq_generate`` and the uncached streamed loop token for token,
    and the JAX ``StreamedModel.seq2seq_generate`` on the same directory up
    to its first EOS (the JAX call leaves rows that emitted EOS running
    while the others go on)."""
    from accelerate_tpu_torch import seq2seq_generate

    t5_hf_dir(tmp_path, variant)
    streamed, _ = load_hf_checkpoint_and_dispatch(str(tmp_path), device_map={"": "cpu"},
                                                  execution_device=CPU)
    src = t5_src()
    cached = streamed.seq2seq_generate(src, max_new_tokens=6, eos_token_id=1,
                                       cache_dtype=torch.float32)
    resident = seq2seq_generate(t5_resident(str(tmp_path)), src, max_new_tokens=6,
                                eos_token_id=1, cache_dtype=torch.float32)
    assert torch.equal(cached, resident[:, :cached.shape[1]])
    assert torch.equal(streamed.seq2seq_generate(src, max_new_tokens=6, eos_token_id=1,
                                                 use_cache=False), cached)
    # Without an EOS the shapes are fixed and the two loops equal.
    free = streamed.seq2seq_generate(src, max_new_tokens=6, cache_dtype=torch.float32)
    assert free.shape == (2, 7)
    assert torch.equal(free, seq2seq_generate(t5_resident(str(tmp_path)), src, max_new_tokens=6,
                                              cache_dtype=torch.float32))
    js, _ = jbm.load_hf_checkpoint_and_dispatch(str(tmp_path), device_map={"": "cpu"})
    ref = np.asarray(js.seq2seq_generate(jnp.asarray(src.numpy(), jnp.int32), max_new_tokens=6,
                                         cache_dtype=jnp.float32))
    for row_ours, row_ref in zip(free.numpy(), ref):
        eos = np.flatnonzero(row_ref == 1)
        stop = eos[0] + 1 if eos.size else len(row_ref)
        np.testing.assert_array_equal(row_ours[:stop], row_ref[:stop])


def test_t5_streamed_model_refuses_decoder_only_generation(tmp_path):
    t5_hf_dir(tmp_path)
    streamed, _ = load_hf_checkpoint_and_dispatch(str(tmp_path), device_map={"": "cpu"},
                                                  execution_device=CPU)
    with pytest.raises(TypeError, match="seq2seq_generate"):
        streamed.generate(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(TypeError, match="seq2seq_generate"):
        generate(streamed, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="src_len"):
        streamed.cache_factory(1, 4)


def test_t5_quantized_loading_matches_jax(tmp_path):
    """int8 off a T5 directory: the dequantized weights equal the JAX
    package's (in the port's layout) exactly; logits within 1e-4."""
    t5_hf_dir(tmp_path, "flan")
    qkw = dict(load_in_8bit=True, min_weight_size=256)
    _, _, jqp, japply = jq.load_and_quantize_hf_checkpoint(
        str(tmp_path), jq.QuantizationConfig(compute_dtype=jnp.float32, **qkw))
    cfg, module, qp, apply = load_and_quantize_hf_checkpoint(
        str(tmp_path), QuantizationConfig(compute_dtype=torch.float32, **qkw), device=CPU)
    quantized = [n for n, t in qp.items() if isinstance(t, QuantizedTensor)]
    assert "encoder_layer.0.attention.query.weight" in quantized
    assert "shared_embedding.weight" in quantized and "lm_head.weight" not in quantized
    want = state_dict_from_flax(jq.dequantize_params(jqp, jnp.float32), cfg)
    for name in quantized:
        np.testing.assert_array_equal(qp[name].dequantize(torch.float32).numpy(),
                                      np.asarray(want[name]), err_msg=name)
    src, tgt = t5_src(), t5_src(S=6) // 2
    with torch.inference_mode():
        got = apply(qp, src, tgt).numpy()
    np.testing.assert_allclose(got, np.asarray(japply(jqp, jnp.asarray(src.numpy(), jnp.int32),
                                                      jnp.asarray(tgt.numpy(), jnp.int32))),
                               atol=1e-4, rtol=1e-4)
