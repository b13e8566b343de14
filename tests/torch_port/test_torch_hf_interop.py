"""HF-layout checkpoints: the port's conversion held against the JAX
package's on the same weights, for llama, mistral (window), qwen2 (q/k/v
biases), gemma and gemma2 (unit-offset norms, softcaps), and for the GPT-style
families, BERT, T5 (relu-tied and flan-style: gated, untied) and ViT on
checkpoints that ``transformers`` itself writes.

Tensors must be equal, not close: conversion renames and never computes.
The one computing check is the forward of a model loaded from an HF
directory, held against the JAX model on the same weights at f32 within
atol/rtol 1e-4 (both run einsum attention; the rest is summation order). It
fails if a square projection (``q_proj``, ``o_proj`` at these widths) comes
out transposed, which no shape check would catch."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.utils import hf_interop as jhf
from accelerate_tpu_torch import LlamaForCausalLM
from accelerate_tpu_torch.utils import hf_interop as phf
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

from torch_big_model_common import FAMILIES, T5_VARIANTS, hf_t5, jax_params, write_hf_dir

TOL = dict(atol=1e-4, rtol=1e-4)


def torch_state(hf: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_and_export_agree_with_jax(family):
    cfg, jcfg, _, params = jax_params(family)
    hf = jhf.export_hf_state_dict(params, family)
    ours = phf.convert_hf_state_dict(torch_state(hf), family, strict=True)
    want = state_dict_from_flax(params, cfg)
    assert set(ours) == set(want)
    for name, t in want.items():
        assert torch.equal(ours[name], t), name
    back = phf.export_hf_state_dict(ours, family)
    assert set(back) == set(hf)
    for key, arr in hf.items():
        np.testing.assert_array_equal(back[key].numpy(), arr)
    # And the JAX package reads the port's export as its own weights.
    jax_back = jhf.convert_hf_state_dict({k: v.numpy() for k, v in back.items()}, family)
    again = state_dict_from_flax(jax_back, cfg)
    assert set(again) == set(want)
    for name, t in want.items():
        assert torch.equal(again[name], t), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_round_trip_agrees_with_jax(family):
    cfg, jcfg, _, _ = jax_params(family)
    if family == "llama":
        cfg = dataclasses.replace(cfg, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 64})
    hf = json.loads(json.dumps(phf.hf_config_from(cfg, family)))
    ours = phf.config_from_hf(hf)
    ref = jhf.config_from_hf(hf)
    assert ours == cfg
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_qwen2_and_gemma2_window_configs_from_hf():
    hf = {"model_type": "qwen2", "num_hidden_layers": 4, "use_sliding_window": True,
          "sliding_window": 16, "max_window_layers": 2}
    for ours, ref in [(phf.config_from_hf(hf), jhf.config_from_hf(hf)),
                      (phf.config_from_hf({**hf, "model_type": "gemma2"}),
                       jhf.config_from_hf({**hf, "model_type": "gemma2"}))]:
        assert ours.layer_windows == ref.layer_windows
        assert ours.sliding_window == ref.sliding_window
    assert phf.config_from_hf(hf).layer_windows == (None, None, 16, 16)


def test_export_casts_floating_tensors():
    cfg, _, _, params = jax_params("qwen2")
    out = phf.export_hf_state_dict(state_dict_from_flax(params, cfg), "qwen2",
                                   dtype=torch.bfloat16)
    assert {t.dtype for t in out.values()} == {torch.bfloat16}
    ref = jhf.export_hf_state_dict(params, "qwen2", dtype=jnp.bfloat16)
    for key, arr in ref.items():
        np.testing.assert_array_equal(out[key].float().numpy(), np.asarray(arr, np.float32))


def test_tied_head_copy_dropped_and_strict_refuses_a_stray_key():
    cfg, _, _, params = jax_params("gemma")
    hf = torch_state(jhf.export_hf_state_dict(params, "gemma"))
    hf["lm_head.weight"] = hf["model.embed_tokens.weight"].clone()
    ours = phf.convert_hf_state_dict(hf, "gemma", strict=True)
    assert "lm_head.weight" not in ours
    with pytest.raises(KeyError, match="no conversion rule"):
        phf.convert_hf_state_dict({**hf, "model.extra.weight": torch.zeros(1)}, "gemma",
                                  strict=True)
    with pytest.raises(KeyError, match="no export rule"):
        phf.export_hf_state_dict({"model.extra.weight": torch.zeros(1)}, "llama")


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma2"])
def test_directory_load_agrees_with_jax(tmp_path, family):
    cfg, jcfg, module, params = jax_params(family)
    d = write_hf_dir(tmp_path / "hf", params, family, cfg, shards=3)
    jcfg2, jparams = jhf.load_hf_checkpoint(d)
    cfg2, ours = phf.load_hf_checkpoint(d)
    assert cfg2 == cfg
    want = state_dict_from_flax(jparams, cfg2)
    assert set(ours) == set(want)
    for name, t in want.items():
        assert torch.equal(ours[name], t), name


def test_square_projections_keep_their_layout(tmp_path):
    cfg, _, module, params = jax_params("llama")
    d = write_hf_dir(tmp_path / "hf", params, "llama", cfg)
    _, ours = phf.load_hf_checkpoint(d)
    q = ours["model.layers.0.self_attn.q_proj.weight"]
    assert q.shape[0] == q.shape[1] and not torch.equal(q, q.T)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(ours)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))
    with torch.inference_mode():
        got = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_saved_directory_reads_in_jax(tmp_path):
    cfg, jcfg, _, params = jax_params("mistral")
    state = state_dict_from_flax(params, cfg)
    phf.save_hf_checkpoint(state, str(tmp_path / "hf"), cfg, "mistral", max_shard_size="40KB")
    index = json.loads((tmp_path / "hf" / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) > 1
    jcfg2, jparams = jhf.load_hf_checkpoint(str(tmp_path / "hf"))
    assert jcfg2.sliding_window == cfg.sliding_window
    back = state_dict_from_flax(jparams, cfg)
    for name, t in state.items():
        assert torch.equal(back[name], t), name


def test_an_unknown_family_is_refused():
    with pytest.raises(ValueError, match="unsupported"):
        phf.detect_family({"model_type": "no_such_family"})
    assert [phf.detect_family({"model_type": f}) for f in ("t5", "vit")] == ["t5", "vit"]


# -- The GPT-style families and BERT, from transformers' own models --------

import transformers  # noqa: E402

from accelerate_tpu_torch.utils.convert import state_dict_from_flax as from_flax  # noqa: E402

#: family -> a tiny transformers model of it (32 wide, 2 layers, 4 heads).
HF_MODELS = {
    "gpt2": lambda: transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64)),
    "opt": lambda: transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=96, hidden_size=32, ffn_dim=64, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, word_embed_proj_dim=32)),
    "gptj": lambda: transformers.GPTJForCausalLM(transformers.GPTJConfig(
        vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64, rotary_dim=4)),
    "gpt_neox": lambda: transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64)),
    "phi": lambda: transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)),
    "bloom": lambda: transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=96, hidden_size=32, n_layer=2, n_head=4)),
    # The JAX BERT computes tanh GELU whatever the config says (reference
    # models/bert.py:80); a gelu_new checkpoint is the one it represents.
    "bert": lambda: transformers.BertForSequenceClassification(transformers.BertConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, hidden_act="gelu_new")),
}


def hf_model(family, seed=0):
    """A transformers model with seeded weights, its norms and biases
    perturbed off 1 and 0."""
    torch.manual_seed(seed)
    model = HF_MODELS[family]().eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


@pytest.mark.parametrize("family", list(HF_MODELS))
def test_transformers_checkpoint_loads_as_in_jax(family):
    """The port reads transformers' state dict (wrapper prefixes and all)
    into the same tensors the JAX package reads it into, its config into
    the same fields, and computes transformers' logits (1e-5); the export
    goes back to the JAX package's export bit for bit."""
    hf = hf_model(family)
    hf_config = hf.config.to_dict()
    state = {k: v.detach() for k, v in hf.state_dict().items()}
    cfg, jcfg = phf.config_from_hf(hf_config), jhf.config_from_hf(hf_config)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    ours = phf.convert_hf_state_dict(state, family, strict=True)
    jparams = jhf.convert_hf_state_dict({k: v.numpy() for k, v in state.items()}, family)
    want = from_flax(jparams, cfg)
    assert set(ours) == set(want)
    for name, t in want.items():
        assert torch.equal(ours[name], t), name
    model = phf.model_from_config(cfg, family, device="cpu")
    model.load_state_dict(ours)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (2, 12)))
    with torch.no_grad():
        ref = hf(x).logits
        np.testing.assert_allclose(model(x).numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    back = phf.export_hf_state_dict(ours, family)
    jback = jhf.export_hf_state_dict(jparams, family)
    assert set(back) == set(jback)
    for key, arr in jback.items():
        np.testing.assert_array_equal(back[key].numpy(), arr, err_msg=key)


def test_gpt2_square_attention_projection_is_transposed_by_value():
    """GPT-2's ``Conv1D`` weights are [in, out]: the port's ``Linear`` holds
    their transpose. ``c_proj`` is square, so only the values tell."""
    hf = hf_model("gpt2", seed=3)
    state = hf.state_dict()
    ours = phf.convert_hf_state_dict(state, "gpt2")
    c_proj = state["transformer.h.0.attn.c_proj.weight"]
    assert c_proj.shape[0] == c_proj.shape[1] and not torch.equal(c_proj, c_proj.T)
    assert torch.equal(ours["h.0.attn_out.weight"], c_proj.T)
    assert torch.equal(ours["h.1.qkv.weight"], state["transformer.h.1.attn.c_attn.weight"].T)
    x = torch.randn(3, 32)
    conv1d = hf.transformer.h[0].attn.c_proj
    with torch.no_grad():
        np.testing.assert_allclose(torch.nn.functional.linear(x, ours["h.0.attn_out.weight"],
                                                              ours["h.0.attn_out.bias"]).numpy(),
                                   conv1d(x).numpy(), atol=1e-6)


@pytest.mark.parametrize("family", list(HF_MODELS))
def test_saved_family_directory_reads_in_jax(tmp_path, family):
    """``save_hf_checkpoint`` of the port's model: the JAX package reads
    the directory into the same config and weights."""
    hf = hf_model(family, seed=4)
    cfg = phf.config_from_hf(hf.config.to_dict())
    state = phf.convert_hf_state_dict(hf.state_dict(), family)
    phf.save_hf_checkpoint(state, str(tmp_path / "hf"), cfg, family, max_shard_size="20KB")
    jcfg, jparams = jhf.load_hf_checkpoint(str(tmp_path / "hf"))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    back = from_flax(jparams, cfg)
    assert set(back) == set(state)
    for name, t in state.items():
        assert torch.equal(back[name], t), name
    cfg2, again = phf.load_hf_checkpoint(str(tmp_path / "hf"))
    assert cfg2 == cfg and all(torch.equal(again[k], t) for k, t in state.items())


# -- T5 and ViT, from transformers' own tiny models -------------------------

def hf_vit(seed=0):
    torch.manual_seed(seed)
    cfg = transformers.ViTConfig(image_size=32, patch_size=8, num_channels=3, hidden_size=32,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 intermediate_size=64)
    cfg.id2label = {0: "a", 1: "b", 2: "c"}
    with torch.no_grad():
        return transformers.ViTForImageClassification(cfg).eval()


def t5_src_tgt():
    src = torch.from_numpy((np.arange(16).reshape(2, 8) * 7) % 100)
    return src, torch.from_numpy((np.arange(12).reshape(2, 6) * 3) % 100)


def assert_same_as_jax(family, hf, cfg, **export_kw):
    """The port reads ``hf``'s state dict into the tensors the JAX package
    reads it into, and its export is the JAX package's bit for bit; the
    round trip (convert, export, convert) is bit-identical. Returns the
    port's state dict."""
    state = {k: v.detach() for k, v in hf.state_dict().items()}
    ours = phf.convert_hf_state_dict(state, family, strict=True)
    jparams = jhf.convert_hf_state_dict({k: v.numpy() for k, v in state.items()}, family)
    want = from_flax(jparams, cfg)
    assert set(ours) == set(want)
    for name, t in want.items():
        assert torch.equal(ours[name], t), name
    back = phf.export_hf_state_dict(ours, family, **export_kw)
    jback = jhf.export_hf_state_dict(jparams, family, **export_kw)
    assert set(back) == set(jback)
    for key, arr in jback.items():
        np.testing.assert_array_equal(back[key].numpy(), arr, err_msg=key)
    again = phf.convert_hf_state_dict(back, family, strict=True)
    assert set(again) == set(ours) and all(torch.equal(again[k], t) for k, t in ours.items())
    return ours


@pytest.mark.parametrize("variant", list(T5_VARIANTS))
def test_t5_checkpoint_loads_as_in_jax(variant):
    """Config fields equal the JAX package's, tensors equal, logits within
    1e-5 of transformers' (tied: the 1/sqrt(d) head; flan: gated MLP,
    untied head), and the round trip is bit-identical."""
    hf = hf_t5(variant)
    hf_config = hf.config.to_dict()
    cfg, jcfg = phf.config_from_hf(hf_config), jhf.config_from_hf(hf_config)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert phf.config_from_hf(json.loads(json.dumps(phf.hf_config_from(cfg, "t5")))) == cfg
    ours = assert_same_as_jax("t5", hf, cfg)
    assert ("lm_head.weight" in ours) == (variant == "flan")
    model = phf.model_from_config(cfg, "t5", device="cpu")
    model.load_state_dict(ours)
    src, tgt = t5_src_tgt()
    with torch.no_grad():
        np.testing.assert_allclose(model(src, tgt).numpy(),
                                   hf(input_ids=src, decoder_input_ids=tgt).logits.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_t5_tied_head_copy_is_dropped():
    hf = hf_t5("relu-tied")
    state = dict(hf.state_dict())
    assert torch.equal(state["lm_head.weight"], state["shared.weight"])
    assert "lm_head.weight" not in phf.convert_hf_state_dict(state, "t5", strict=True)
    state["lm_head.weight"] = state["lm_head.weight"] + 1.0  # an untied head converts
    assert "lm_head.weight" in phf.convert_hf_state_dict(state, "t5", strict=True)


def test_vit_checkpoint_loads_as_in_jax():
    """As for T5, and the export factors the patch projection back into
    the conv kernel only with ``config=``."""
    hf = hf_vit()
    hf_config = {**hf.config.to_dict(), "model_type": "vit"}
    cfg, jcfg = phf.config_from_hf(hf_config), jhf.config_from_hf(hf_config)
    assert cfg.num_labels == 3 and cfg.patch_size == 8
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert phf.config_from_hf(json.loads(json.dumps(phf.hf_config_from(cfg, "vit")))) == cfg
    ours = assert_same_as_jax("vit", hf, cfg, config=cfg)
    with pytest.raises(ValueError, match="needs config"):
        phf.export_hf_state_dict(ours, "vit")
    kernel = hf.state_dict()["vit.embeddings.patch_embeddings.projection.weight"]
    assert torch.equal(phf.export_hf_state_dict(ours, "vit", prefix="vit.", config=cfg)[
        "vit.embeddings.patch_embeddings.projection.weight"], kernel)
    model = phf.model_from_config(cfg, "vit", device="cpu")
    model.load_state_dict(ours)
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy(),
                                   hf(torch.from_numpy(x)).logits.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", ["t5", "vit"])
def test_saved_t5_and_vit_directories_read_in_jax(tmp_path, family):
    hf = hf_t5("flan", seed=1) if family == "t5" else hf_vit(seed=1)
    cfg = phf.config_from_hf({**hf.config.to_dict(), "model_type": family})
    state = phf.convert_hf_state_dict(hf.state_dict(), family)
    phf.save_hf_checkpoint(state, str(tmp_path / "hf"), cfg, family, max_shard_size="20KB")
    jcfg, jparams = jhf.load_hf_checkpoint(str(tmp_path / "hf"))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    back = from_flax(jparams, cfg)
    assert set(back) == set(state) and all(torch.equal(back[k], t) for k, t in state.items())
    cfg2, again = phf.load_hf_checkpoint(str(tmp_path / "hf"))
    assert cfg2 == cfg and all(torch.equal(again[k], t) for k, t in state.items())


@pytest.mark.parametrize("variant", list(T5_VARIANTS))
def test_t5_seq2seq_generate_matches_transformers(variant):
    """Greedy ``seq2seq_generate`` against transformers' ``generate``:
    equal arrays with ``min_new_tokens`` on both sides (no early EOS), and
    equal up to and including transformers' first EOS without it (past it
    transformers pads, the port repeats EOS)."""
    from accelerate_tpu_torch import seq2seq_generate

    hf = hf_t5(variant, seed=2)
    cfg = phf.config_from_hf(hf.config.to_dict())
    model = phf.model_from_config(cfg, "t5", device="cpu")
    model.load_state_dict(phf.convert_hf_state_dict(hf.state_dict(), "t5"))
    src, _ = t5_src_tgt()
    for min_new in (7, 0):
        ours = seq2seq_generate(model, src, max_new_tokens=7, eos_token_id=1,
                                min_new_tokens=min_new, cache_dtype=torch.float32).numpy()
        with torch.no_grad():
            theirs = hf.generate(src, attention_mask=torch.ones_like(src), max_new_tokens=7,
                                 min_new_tokens=min_new, do_sample=False).numpy()
        for row_ours, row_hf in zip(ours, theirs):
            eos = np.flatnonzero(row_hf == 1)
            stop = eos[0] + 1 if eos.size else len(row_hf)
            np.testing.assert_array_equal(row_ours[:stop], row_hf[:stop])
            assert (row_ours[stop:] == 1).all()


@pytest.mark.parametrize("buckets", [(32, 128), (8, 20)], ids=["32-128", "8-20"])
def test_t5_bucket_table_equals_transformers(buckets):
    """The reference's ``log(n / max_exact + 1e-6)`` (HF's has no 1e-6)
    flips no bucket against transformers' for -4096..4096, both ways."""
    from transformers.models.t5.modeling_t5 import T5Attention

    from accelerate_tpu_torch.models.t5 import relative_position_bucket

    rel = torch.arange(-4096, 4097)
    for bidirectional in (True, False):
        assert torch.equal(relative_position_bucket(rel, bidirectional, *buckets),
                           T5Attention._relative_position_bucket(rel, bidirectional, *buckets))
