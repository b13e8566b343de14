"""Helpers of the big-model tests: seeded JAX Llama-family weights, and an
HF-layout checkpoint directory written from them by the JAX package's own
``export_hf_state_dict`` (plus a safetensors writer), which both packages
then load; transformers' own tiny T5 (:func:`hf_t5`)."""

import json
import os

import jax
import numpy as np
from safetensors.numpy import save_file

from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu.utils.hf_interop import export_hf_state_dict as jax_export_hf
from accelerate_tpu_torch.models.llama import LlamaConfig
from accelerate_tpu_torch.utils.hf_interop import hf_config_from

# Family -> LlamaConfig.tiny overrides (f32; small enough for the CPU).
FAMILIES = {
    "llama": {},
    "mistral": dict(sliding_window=6),
    "qwen2": dict(attention_qkv_bias=True, rms_norm_eps=1e-6),
    "gemma": dict(head_dim_override=24, tie_word_embeddings=True, mlp_activation="gelu_tanh",
                  rms_norm_unit_offset=True, scale_embeddings=True, rms_norm_eps=1e-6),
    "gemma2": dict(head_dim_override=24, layer_windows=(8, None), attn_logit_softcapping=5.0,
                   final_logit_softcapping=3.0, post_norms=True, rms_norm_unit_offset=True,
                   scale_embeddings=True, mlp_activation="gelu_tanh", query_pre_attn_scalar=20.0,
                   tie_word_embeddings=True, rms_norm_eps=1e-6),
}


def jax_params(family="llama", seed=0, **extra):
    """(port config, JAX config, JAX module, params): JAX's init perturbed
    from a numpy seed, so biases and norm scales are not trivially 0/1."""
    overrides = {**FAMILIES[family], **extra}
    jcfg = JaxLlamaConfig.tiny(**overrides)
    module = JaxLlamaForCausalLM(jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    return LlamaConfig.tiny(**overrides), jcfg, module, params


def write_hf_dir(directory, params, family, config, shards=2):
    """An HF checkpoint directory: ``config.json``, the JAX package's export
    of ``params`` split over ``shards`` files and the index."""
    os.makedirs(directory, exist_ok=True)
    hf = {k: np.ascontiguousarray(v) for k, v in jax_export_hf(params, family).items()}
    keys = sorted(hf)
    parts = np.array_split(np.arange(len(keys)), shards)
    weight_map = {}
    for i, part in enumerate(parts):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({keys[j]: hf[keys[j]] for j in part}, os.path.join(directory, name))
        weight_map.update({keys[j]: name for j in part})
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config_from(config, family), f)
    return str(directory)


def jax_name(name: str) -> str:
    """A port name as the JAX package spells it (``layers.<i>`` ->
    ``layers_<i>``, ``weight`` -> ``kernel`` or ``embedding``), the map
    that makes two device maps or size tables comparable."""
    parts = name.split(".")
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if out[-1] == "weight":
        out[-1] = "embedding" if out[-2] == "embed_tokens" else "kernel"
    return ".".join(out)


#: transformers' T5 variants the tests build: v1.0 (relu, the head tied to
#: the embedding) and v1.1/flan (gated GELU, an untied head).
T5_VARIANTS = {"relu-tied": dict(feed_forward_proj="relu", tie_word_embeddings=True),
               "flan": dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False)}


def hf_t5(variant="relu-tied", seed=0):
    """transformers' tiny T5 of the JAX package's tests (32 wide, 2 + 2
    layers, 4 heads of 8, 8 buckets up to distance 20), seeded, in eval
    mode."""
    import torch
    import transformers

    torch.manual_seed(seed)
    cfg = transformers.T5Config(
        vocab_size=100, d_model=32, d_ff=64, d_kv=8, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=20, dropout_rate=0.0,
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=0, **T5_VARIANTS[variant])
    with torch.no_grad():
        return transformers.T5ForConditionalGeneration(cfg).eval()
