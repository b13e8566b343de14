"""HuggingFace Transformers checkpoints of the port's model families.

Counterpart of ``accelerate_tpu/utils/hf_interop.py`` for the families the
port's ``LlamaForCausalLM`` covers (llama, mistral, qwen2, gemma, gemma2),
those its ``MixtralForCausalLM`` covers (mixtral, qwen2_moe), the GPT-style
families (gpt2, opt, gptj, gpt_neox, phi, bloom), bert, vit and t5. The JAX
package's tables map HF names onto a flax tree and transpose every
projection (op ``"t"``: HF ``Linear.weight`` is ``[out, in]``, a flax
kernel ``[in, out]``). The port's ``nn.Linear.weight`` is ``[out, in]``
too, so here a ``Linear`` crosses as it is and only the names change
(``input_layernorm.weight`` -> ``input_norm.scale``, ...). A square
projection carried across with the JAX op would come out transposed with no
shape check to catch it; the tests hold both packages' loads of one
directory against each other.

GPT-2 is the inverse case: its HF ``Conv1D`` weights are stored ``[in,
out]`` already, so the JAX rules copy them into flax kernels as they are
(reference ``:107-118``), and here they are the one place that *must*
transpose (op ``"t"``) into the port's ``[out, in]``. Its ``attn.c_proj``
is square (1600 x 1600 in GPT-2 XL), so a missed transpose would pass
every shape check; a test compares it by value. HF wrapper prefixes
(``transformer.``, ``model.decoder.``, ``gpt_neox.``, ``model.``,
``bert.``) are stripped before matching, as in the reference.

The MoE leaves are the exception, because the port keeps the JAX layout
for them (``models/mixtral.py``): the router is ``[D, E]`` where HF's
``gate.weight`` is ``[E, D]`` (op ``"t"``), and each HF expert's
``Linear.weight`` (Mixtral's ``w1`` = gate ``[F, D]``, ``w2`` = down
``[D, F]``, ``w3`` = up ``[F, D]``; Qwen2-MoE's ``gate_proj``/``up_proj``/
``down_proj``) is transposed and stacked on a leading expert dim into
``[E, in, out]`` (op ``"stack:<e>:t"``, :func:`map_hf_key_and_op`).

ViT's patch projection is a ``Linear`` over ``(c, ph, pw)``-flattened
patches: HF's ``Conv2d`` kernel ``[D, C, p, p]`` reshapes into its weight
``[D, C*p*p]`` (op ``"cf"``, the JAX op's transpose dropped), and the export
factors it back, which takes ``config=`` (the shape alone does not say C
and p). T5 v1.1/flan checkpoints name the gated MLP ``wi_0``/``wi_1``,
v1.0 ``wi``; the export of a gated model writes ``wi_0``. A tied T5
checkpoint's ``lm_head`` equal to ``shared`` is dropped.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from ..models.llama import LlamaConfig, scale_rope_frequencies

__all__ = [
    "detect_family",
    "config_from_hf",
    "hf_config_from",
    "convert_hf_state_dict",
    "export_hf_state_dict",
    "load_hf_checkpoint",
    "save_hf_checkpoint",
]

# (HF template, port template, alternatives for {p}[, op]); {i} is a layer
# index; op "t" transposes a 2-D tensor (the router), else none.
_LLAMA_RULES = [
    ("model.embed_tokens.weight", "model.embed_tokens.weight", None),
    ("model.layers.{i}.self_attn.{p}_proj.weight",
     "model.layers.{i}.self_attn.{p}_proj.weight", ("q", "k", "v", "o")),
    ("model.layers.{i}.mlp.{p}_proj.weight",
     "model.layers.{i}.mlp.{p}_proj.weight", ("gate", "up", "down")),
    ("model.layers.{i}.input_layernorm.weight", "model.layers.{i}.input_norm.scale", None),
    ("model.layers.{i}.post_attention_layernorm.weight",
     "model.layers.{i}.post_attn_norm.scale", None),
    ("model.norm.weight", "model.norm.scale", None),
    ("lm_head.weight", "lm_head.weight", None),
]

# Qwen2: llama-named tensors plus biases on the q/k/v projections.
_QWEN2_RULES = _LLAMA_RULES + [
    ("model.layers.{i}.self_attn.{p}_proj.bias",
     "model.layers.{i}.self_attn.{p}_proj.bias", ("q", "k", "v")),
]

# Gemma2: llama-named tensors plus the sandwich-norm pair around the MLP.
_GEMMA2_RULES = _LLAMA_RULES + [
    ("model.layers.{i}.pre_feedforward_layernorm.weight",
     "model.layers.{i}.pre_ffn_norm.scale", None),
    ("model.layers.{i}.post_feedforward_layernorm.weight",
     "model.layers.{i}.post_ffn_norm.scale", None),
]


def _flat(rules):
    """Llama-family rules without the MLP, for ``MixtralForCausalLM``,
    which has no ``model.`` scope."""
    return [(hf_t, ours_t.removeprefix("model."), alts) for hf_t, ours_t, alts in rules
            if ".mlp." not in hf_t]


# Mixtral: llama attention and norms, the router ([E, D] in HF, [D, E]
# here: op "t"); the experts are stacked by _EXPERT_CONVENTIONS.
_MIXTRAL_RULES = _flat(_LLAMA_RULES) + [
    ("model.layers.{i}.block_sparse_moe.gate.weight", "layers.{i}.mlp.router", None, "t"),
]

# Qwen2-MoE: qwen2 attention (q/k/v biases), the router, the sigmoid-gated
# shared expert, and the dense MLP of mlp_only_layers.
_QWEN2_MOE_RULES = _flat(_QWEN2_RULES) + [
    ("model.layers.{i}.mlp.gate.weight", "layers.{i}.mlp.router", None, "t"),
    ("model.layers.{i}.mlp.shared_expert.{p}_proj.weight",
     "layers.{i}.mlp.shared_{p}_proj.weight", ("gate", "up", "down")),
    ("model.layers.{i}.mlp.shared_expert_gate.weight",
     "layers.{i}.mlp.shared_expert_gate.weight", None),
    ("model.layers.{i}.mlp.{p}_proj.weight", "layers.{i}.mlp.{p}_proj.weight",
     ("gate", "up", "down")),
]

# GPT-2: HF Conv1D weights are [in, out]: the port's Linear takes them
# transposed (op "t"); the fused qkv is q|k|v on the output axis.
_GPT2_RULES = [
    ("wte.weight", "wte.weight", None),
    ("wpe.weight", "wpe.weight", None),
    ("h.{i}.ln_{p}.weight", "h.{i}.ln_{p}.scale", ("1", "2")),
    ("h.{i}.ln_{p}.bias", "h.{i}.ln_{p}.bias", ("1", "2")),
    ("h.{i}.attn.c_attn.weight", "h.{i}.qkv.weight", None, "t"),
    ("h.{i}.attn.c_attn.bias", "h.{i}.qkv.bias", None),
    ("h.{i}.attn.c_proj.weight", "h.{i}.attn_out.weight", None, "t"),
    ("h.{i}.attn.c_proj.bias", "h.{i}.attn_out.bias", None),
    ("h.{i}.mlp.c_fc.weight", "h.{i}.fc1.weight", None, "t"),
    ("h.{i}.mlp.c_fc.bias", "h.{i}.fc1.bias", None),
    ("h.{i}.mlp.c_proj.weight", "h.{i}.fc2.weight", None, "t"),
    ("h.{i}.mlp.c_proj.bias", "h.{i}.fc2.bias", None),
    ("ln_f.weight", "ln_f.scale", None),
    ("ln_f.bias", "ln_f.bias", None),
]


def _norm(hf_name: str, ours: str) -> list:
    """The weight and bias rules of one LayerNorm (HF ``weight`` -> the
    port's ``scale``)."""
    return [(f"{hf_name}.weight", f"{ours}.scale", None), (f"{hf_name}.bias", f"{ours}.bias", None)]


def _linear(hf_name: str, ours: str, alts=None, bias: bool = True) -> list:
    """The weight (and bias) rules of one ``Linear``, crossing as they are."""
    rules = [(f"{hf_name}.weight", f"{ours}.weight", alts)]
    return rules + ([(f"{hf_name}.bias", f"{ours}.bias", alts)] if bias else [])


# BLOOM: QKV fused per head (H blocks of [q|k|v]) keeps its layout.
_BLOOM_RULES = [
    ("word_embeddings.weight", "word_embeddings.weight", None),
    *_norm("word_embeddings_layernorm", "word_embeddings_layernorm"),
    *_norm("h.{i}.input_layernorm", "layers.{i}.input_layernorm"),
    *_linear("h.{i}.self_attention.query_key_value", "layers.{i}.query_key_value"),
    *_linear("h.{i}.self_attention.dense", "layers.{i}.dense"),
    *_norm("h.{i}.post_attention_layernorm", "layers.{i}.post_attention_layernorm"),
    *_linear("h.{i}.mlp.dense_{p}", "layers.{i}.dense_{p}", ("h_to_4h", "4h_to_h")),
    *_norm("ln_f", "ln_f"),
]

_OPT_RULES = [
    ("embed_tokens.weight", "embed_tokens.weight", None),
    ("embed_positions.weight", "embed_positions.weight", None),
    *_linear("layers.{i}.self_attn.{p}_proj", "layers.{i}.{p}_proj", ("q", "k", "v", "out")),
    *_norm("layers.{i}.self_attn_layer_norm", "layers.{i}.self_attn_layer_norm"),
    *_linear("layers.{i}.fc{p}", "layers.{i}.fc{p}", ("1", "2")),
    *_norm("layers.{i}.final_layer_norm", "layers.{i}.final_layer_norm"),
    *_norm("final_layer_norm", "final_layer_norm"),
]

# GPT-J: unbiased attention projections; the head is untied AND biased.
_GPTJ_RULES = [
    ("wte.weight", "wte.weight", None),
    *_norm("h.{i}.ln_1", "h.{i}.ln_1"),
    *_linear("h.{i}.attn.{p}_proj", "h.{i}.{p}_proj", ("q", "k", "v", "out"), bias=False),
    *_linear("h.{i}.mlp.fc_{p}", "h.{i}.fc_{p}", ("in", "out")),
    *_norm("ln_f", "ln_f"),
    *_linear("lm_head", "lm_head"),
]

# GPT-NeoX: QKV fused per head (H blocks of [q|k|v]) keeps its layout.
_GPT_NEOX_RULES = [
    ("embed_in.weight", "embed_in.weight", None),
    *_norm("layers.{i}.input_layernorm", "layers.{i}.input_layernorm"),
    *_linear("layers.{i}.attention.query_key_value", "layers.{i}.query_key_value"),
    *_linear("layers.{i}.attention.dense", "layers.{i}.dense"),
    *_norm("layers.{i}.post_attention_layernorm", "layers.{i}.post_attention_layernorm"),
    *_linear("layers.{i}.mlp.dense_{p}", "layers.{i}.dense_{p}", ("h_to_4h", "4h_to_h")),
    *_norm("final_layer_norm", "final_layer_norm"),
    ("embed_out.weight", "embed_out.weight", None),
]

# Phi: the head is untied AND biased.
_PHI_RULES = [
    ("embed_tokens.weight", "embed_tokens.weight", None),
    *_norm("layers.{i}.input_layernorm", "layers.{i}.input_layernorm"),
    *_linear("layers.{i}.self_attn.{p}_proj", "layers.{i}.{p}_proj", ("q", "k", "v")),
    *_linear("layers.{i}.self_attn.dense", "layers.{i}.dense"),
    *_linear("layers.{i}.mlp.fc{p}", "layers.{i}.fc{p}", ("1", "2")),
    *_norm("final_layernorm", "final_layernorm"),
    *_linear("lm_head", "lm_head"),
]

def _t5_stack(hf: str, ours: str, mlp_sublayer: int, decoder: bool) -> list:
    """The rules of one T5 stack's blocks: HF ``{hf}.block.{i}.layer.<j>``
    -> the port's ``{ours}.{i}``."""
    attn = [("q", "query"), ("k", "key"), ("v", "value"), ("o", "attn_out")]
    self_attn = "self_attention" if decoder else "attention"
    rules = [(f"{hf}.block.{{i}}.layer.0.SelfAttention.{a}.weight",
              f"{ours}.{{i}}.{self_attn}.{b}.weight", None) for a, b in attn]
    rules += [
        (f"{hf}.block.{{i}}.layer.0.SelfAttention.relative_attention_bias.weight",
         f"{ours}.{{i}}.{self_attn}.relative_attention_bias.weight", None),
        (f"{hf}.block.{{i}}.layer.0.layer_norm.weight",
         f"{ours}.{{i}}.{'self_norm' if decoder else 'attn_norm'}.scale", None)]
    if decoder:
        rules += [(f"{hf}.block.{{i}}.layer.1.EncDecAttention.{a}.weight",
                   f"{ours}.{{i}}.cross_attention.{b}.weight", None) for a, b in attn]
        rules.append((f"{hf}.block.{{i}}.layer.1.layer_norm.weight",
                      f"{ours}.{{i}}.cross_norm.scale", None))
    mlp = f"{hf}.block.{{i}}.layer.{mlp_sublayer}"
    # wi (v1.0) first, so the export of a relu model writes it; a gated
    # model's wi_0 is the activated projection, wi_1 the linear gate.
    rules += [(f"{mlp}.DenseReluDense.{a}.weight", f"{ours}.{{i}}.mlp.{b}.weight", None)
              for a, b in (("wi", "intermediate"), ("wi_0", "intermediate"),
                           ("wi_1", "intermediate_gate"), ("wo", "mlp_out"))]
    return rules + [(f"{mlp}.layer_norm.weight", f"{ours}.{{i}}.mlp_norm.scale", None),
                    (f"{hf}.final_layer_norm.weight", f"{ours.split('_')[0]}_norm.scale", None)]


_T5_RULES = [
    ("shared.weight", "shared_embedding.weight", None),
    *_t5_stack("encoder", "encoder_layer", 1, decoder=False),
    *_t5_stack("decoder", "decoder_layer", 2, decoder=True),
    ("lm_head.weight", "lm_head.weight", None),
]

# ViT: the conv kernel [D, C, p, p] is the patch Linear's weight reshaped
# (op "cf"); cls_token and position_embeddings are bare parameters.
_VIT_RULES = [
    ("embeddings.cls_token", "cls_token", None),
    ("embeddings.position_embeddings", "position_embeddings", None),
    ("embeddings.patch_embeddings.projection.weight", "patch_projection.weight", None, "cf"),
    ("embeddings.patch_embeddings.projection.bias", "patch_projection.bias", None),
    *_norm("encoder.layer.{i}.layernorm_before", "layer.{i}.norm_before"),
    *_linear("encoder.layer.{i}.attention.attention.{p}", "layer.{i}.attention.{p}",
             ("query", "key", "value")),
    *_linear("encoder.layer.{i}.attention.output.dense", "layer.{i}.attention.attn_out"),
    *_norm("encoder.layer.{i}.layernorm_after", "layer.{i}.norm_after"),
    *_linear("encoder.layer.{i}.intermediate.dense", "layer.{i}.intermediate"),
    *_linear("encoder.layer.{i}.output.dense", "layer.{i}.mlp_out"),
    *_norm("layernorm", "norm"),
    *_linear("classifier", "classifier"),
]

_BERT_RULES = [
    *[(f"embeddings.{p}_embeddings.weight", f"encoder.{p}_embeddings.weight", None)
      for p in ("word", "position", "token_type")],
    *_norm("embeddings.LayerNorm", "encoder.embed_norm"),
    *_linear("encoder.layer.{i}.attention.self.{p}", "encoder.layer.{i}.attention.{p}",
             ("query", "key", "value")),
    *_linear("encoder.layer.{i}.attention.output.dense", "encoder.layer.{i}.attention.attn_out"),
    *_norm("encoder.layer.{i}.attention.output.LayerNorm", "encoder.layer.{i}.attn_norm"),
    *_linear("encoder.layer.{i}.intermediate.dense", "encoder.layer.{i}.intermediate"),
    *_linear("encoder.layer.{i}.output.dense", "encoder.layer.{i}.mlp_out"),
    *_norm("encoder.layer.{i}.output.LayerNorm", "encoder.layer.{i}.mlp_norm"),
    *_linear("pooler.dense", "pooler"),
    *_linear("classifier", "classifier"),
]

# Per-expert HF Linears -> the stacked [E, in, out] leaves: per family, the
# regex with (layer, expert, projection token) groups, token -> the port's
# leaf, and (layer, expert, token) -> the HF key.
_EXPERT_CONVENTIONS = {
    "mixtral": (
        re.compile(r"model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w([123])\.weight"),
        {"1": "gate_proj", "2": "down_proj", "3": "up_proj"},
        lambda layer, e, tok: f"model.layers.{layer}.block_sparse_moe.experts.{e}.w{tok}.weight",
    ),
    "qwen2_moe": (
        re.compile(r"model\.layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)"
                   r"\.weight"),
        {p: p for p in ("gate_proj", "up_proj", "down_proj")},
        lambda layer, e, tok: f"model.layers.{layer}.mlp.experts.{e}.{tok}.weight",
    ),
}
_EXPERT_LEAF = re.compile(r"^layers\.(\d+)\.mlp\.experts\.(gate_proj|up_proj|down_proj)$")

# Mistral and Gemma checkpoints are llama-named tensor for tensor; their
# differences live in config_from_hf.
_FAMILY_RULES = {
    "llama": _LLAMA_RULES,
    "mistral": _LLAMA_RULES,
    "qwen2": _QWEN2_RULES,
    "gemma": _LLAMA_RULES,
    "gemma2": _GEMMA2_RULES,
    "mixtral": _MIXTRAL_RULES,
    "qwen2_moe": _QWEN2_MOE_RULES,
    "gpt2": _GPT2_RULES,
    "gptj": _GPTJ_RULES,
    "gpt_neox": _GPT_NEOX_RULES,
    "bloom": _BLOOM_RULES,
    "opt": _OPT_RULES,
    "phi": _PHI_RULES,
    "bert": _BERT_RULES,
    "vit": _VIT_RULES,
    "t5": _T5_RULES,
}

# The prefixes HF wrapper classes add around the base model, stripped
# before matching (reference :434-440), so e.g. both BertModel and
# BertForSequenceClassification load.
_STRIP_PREFIXES = {
    "gpt2": ("transformer.",),
    "gptj": ("transformer.",),
    "gpt_neox": ("gpt_neox.",),
    "bloom": ("transformer.",),
    "opt": ("model.decoder.", "decoder."),
    "phi": ("model.",),
    "bert": ("bert.",),
    "vit": ("vit.",),
}

# The embedding a tied checkpoint's lm_head copies, where it is not Llama's.
_TIED_EMBEDDING = {"t5": "shared.weight"}

# HF keys that are legitimately rule-less: a tied head's copy, buffers and
# heads the port's models do not have.
_SKIPPABLE = re.compile(
    r"(^|\.)(lm_head\.weight|predictions\..*|position_ids|rotary_emb\.inv_freq"
    r"|encoder\.embed_tokens\.weight|decoder\.embed_tokens\.weight"
    r"|attn\.(bias|masked_bias)|attention\.(bias|masked_bias))$")

# HF's GELU spellings the models evaluate: "gelu" and "gelu_python" are the
# exact erf form, the rest the tanh approximation (reference).
_GELU_VARIANTS = {"gelu", "gelu_python", "gelu_new", "gelu_fast", "gelu_pytorch_tanh"}


def _compile_rules(rules):
    compiled = []
    for hf_t, ours_t, alts, *op in rules:
        pats = []
        for t in (hf_t, ours_t):
            pat = re.escape(t).replace(r"\{i\}", r"(?P<i>\d+)")
            if alts:
                pat = pat.replace(r"\{p\}", f"(?P<p>{'|'.join(alts)})")
            pats.append(re.compile(f"^{pat}$"))
        compiled.append((pats[0], pats[1], hf_t, ours_t, op[0] if op else None))
    return compiled


_COMPILED = {fam: _compile_rules(rules) for fam, rules in _FAMILY_RULES.items()}


def _fill(template: str, match: re.Match) -> str:
    out = template
    for name, val in match.groupdict().items():
        out = out.replace("{" + name + "}", val)
    return out


def _check_family(family: str) -> None:
    if family in _COMPILED:
        return
    raise ValueError(f"unsupported family {family!r}; supported: {sorted(_COMPILED)}")


def detect_family(hf_config: dict) -> str:
    """Family name from an HF ``config.json`` dict (its ``model_type``)."""
    family = str(hf_config.get("model_type", "")).lower()
    _check_family(family)
    return family


def _qwen_windows(get, n: int) -> tuple:
    """Qwen2's sliding windows, ``(uniform window, per-layer windows)``
    with one of them None: only when the config opts in, the first
    ``max_window_layers`` layers staying full attention."""
    if not get("use_sliding_window"):
        return None, None
    if get("layer_types"):
        windows = tuple(get("sliding_window") if t == "sliding_attention" else None
                        for t in get("layer_types"))
    else:
        full = get("max_window_layers", n)
        windows = tuple(None if i < full else get("sliding_window") for i in range(n))
    if len(set(windows)) == 1:
        return windows[0], None
    return None, windows


def _gelu_act(get, key: str, default: str) -> str:
    act = get(key, default)
    if act not in _GELU_VARIANTS:
        raise NotImplementedError(f"{key} {act!r} (supported: {sorted(_GELU_VARIANTS)})")
    return act


def _family_config(family: str, get):
    """The config of a GPT-style family, BERT, ViT or T5 (reference
    :666-840), with the reference's refusals of what its models cannot
    represent."""
    if family == "vit":
        from ..models.vit import ViTConfig

        if get("hidden_act", "gelu") != "gelu":
            raise NotImplementedError(f"hidden_act {get('hidden_act')!r}: the ViT MLP is exact "
                                      "gelu")
        if not get("qkv_bias", True):
            raise NotImplementedError("qkv_bias=False ViT variants are not representable (the "
                                      "attention projections carry biases)")
        return ViTConfig(image_size=get("image_size", 224), patch_size=get("patch_size", 16),
                         num_channels=get("num_channels", 3),
                         hidden_size=get("hidden_size", 768),
                         num_hidden_layers=get("num_hidden_layers", 12),
                         num_attention_heads=get("num_attention_heads", 12),
                         intermediate_size=get("intermediate_size", 3072),
                         layer_norm_eps=get("layer_norm_eps", 1e-12),
                         hidden_dropout_prob=get("hidden_dropout_prob", 0.0),
                         attention_probs_dropout_prob=get("attention_probs_dropout_prob", 0.0),
                         num_labels=len(get("id2label", {i: i for i in range(1000)})))
    if family == "t5":
        from ..models.t5 import T5Config

        layers = get("num_layers", 6)
        if get("num_decoder_layers") not in (None, layers):
            raise NotImplementedError(f"num_decoder_layers {get('num_decoder_layers')} != "
                                      f"num_layers {layers}: both stacks have num_layers")
        return T5Config(vocab_size=get("vocab_size", 32128), hidden_size=get("d_model", 512),
                        intermediate_size=get("d_ff", 2048), num_layers=layers,
                        num_heads=get("num_heads", 8), head_dim=get("d_kv", 64),
                        relative_attention_num_buckets=get("relative_attention_num_buckets", 32),
                        relative_attention_max_distance=get("relative_attention_max_distance",
                                                            128),
                        layer_norm_eps=get("layer_norm_epsilon", 1e-6),
                        dropout_rate=get("dropout_rate", 0.1),
                        feed_forward_proj=get("feed_forward_proj", "relu"),
                        tie_word_embeddings=get("tie_word_embeddings", True))
    if family == "gpt2":
        from ..models.gpt2 import GPT2Config

        return GPT2Config(vocab_size=get("vocab_size", 50257), hidden_size=get("n_embd", 768),
                          num_hidden_layers=get("n_layer", 12),
                          num_attention_heads=get("n_head", 12),
                          max_position_embeddings=get("n_positions", 1024),
                          layer_norm_eps=get("layer_norm_epsilon", 1e-5))
    if family == "opt":
        from ..models.opt import OPTConfig

        if not get("do_layer_norm_before", True):
            raise NotImplementedError("do_layer_norm_before=False OPT variants (350m) are "
                                      "post-LN; the decoder is pre-LN only")
        if get("word_embed_proj_dim", get("hidden_size")) != get("hidden_size"):
            raise NotImplementedError("word_embed_proj_dim != hidden_size (OPT-350m's "
                                      "projection) is not representable")
        if not get("enable_bias", True) or not get("layer_norm_elementwise_affine", True):
            raise NotImplementedError("bias-less or non-affine-LN OPT variants are not "
                                      "representable (the decoder has biased projections and "
                                      "affine norms)")
        act = get("activation_function", "relu")
        if act not in ("relu", "gelu"):
            raise NotImplementedError(f"activation_function {act!r} (relu/gelu only)")
        return OPTConfig(vocab_size=get("vocab_size", 50272),
                         hidden_size=get("hidden_size", 768),
                         intermediate_size=get("ffn_dim", 3072),
                         num_hidden_layers=get("num_hidden_layers", 12),
                         num_attention_heads=get("num_attention_heads", 12),
                         max_position_embeddings=get("max_position_embeddings", 2048),
                         activation=act)
    if family == "gptj":
        from ..models.gptj import GPTJConfig

        return GPTJConfig(vocab_size=get("vocab_size", 50400), hidden_size=get("n_embd", 4096),
                          intermediate_size=get("n_inner") or 4 * get("n_embd", 4096),
                          num_hidden_layers=get("n_layer", 28),
                          num_attention_heads=get("n_head", 16),
                          max_position_embeddings=get("n_positions", 2048),
                          rotary_dim=get("rotary_dim") or (get("n_embd", 4096)
                                                           // get("n_head", 16)),
                          activation=_gelu_act(get, "activation_function", "gelu_new"),
                          layer_norm_eps=get("layer_norm_epsilon", 1e-5))
    if family == "phi":
        from ..models.phi import PhiConfig

        act = _gelu_act(get, "hidden_act", "gelu_new")
        if get("qk_layernorm", False):
            raise NotImplementedError("qk_layernorm Phi variants are not representable (the "
                                      "attention has no per-head q/k norms)")
        return PhiConfig(vocab_size=get("vocab_size", 51200),
                         hidden_size=get("hidden_size", 2560),
                         intermediate_size=get("intermediate_size", 10240),
                         num_hidden_layers=get("num_hidden_layers", 32),
                         num_attention_heads=get("num_attention_heads", 32),
                         num_key_value_heads=get("num_key_value_heads",
                                                 get("num_attention_heads", 32)),
                         max_position_embeddings=get("max_position_embeddings", 2048),
                         partial_rotary_factor=get("partial_rotary_factor", 0.4),
                         rope_theta=get("rope_theta", 10000.0), hidden_act=act,
                         layer_norm_eps=get("layer_norm_eps", 1e-5))
    if family == "bloom":
        from ..models.bloom import BloomConfig

        if get("slow_but_exact"):
            raise NotImplementedError("slow_but_exact BLOOM inference reorders the matmul "
                                      "accumulation; the forward is the standard path")
        return BloomConfig(vocab_size=get("vocab_size", 250880),
                           hidden_size=get("hidden_size", get("n_embed", 1024)),
                           num_hidden_layers=get("n_layer", get("num_hidden_layers", 24)),
                           num_attention_heads=get("n_head", get("num_attention_heads", 16)),
                           layer_norm_epsilon=get("layer_norm_epsilon", 1e-5))
    if family == "gpt_neox":
        from ..models.gpt_neox import GPTNeoXConfig

        act = _gelu_act(get, "hidden_act", "gelu")
        if not get("attention_bias", True):
            raise NotImplementedError("attention_bias=False GPT-NeoX variants are not "
                                      "representable (the projections have biases)")
        return GPTNeoXConfig(vocab_size=get("vocab_size", 50432),
                             hidden_size=get("hidden_size", 768),
                             intermediate_size=get("intermediate_size", 3072),
                             num_hidden_layers=get("num_hidden_layers", 12),
                             num_attention_heads=get("num_attention_heads", 12),
                             max_position_embeddings=get("max_position_embeddings", 2048),
                             rotary_pct=get("rotary_pct", 0.25),
                             rope_theta=get("rotary_emb_base", get("rope_theta", 10000.0)),
                             use_parallel_residual=get("use_parallel_residual", True),
                             hidden_act=act, layer_norm_eps=get("layer_norm_eps", 1e-5))
    from ..models.bert import BertConfig

    return BertConfig(vocab_size=get("vocab_size", 30522), hidden_size=get("hidden_size", 768),
                      num_hidden_layers=get("num_hidden_layers", 12),
                      num_attention_heads=get("num_attention_heads", 12),
                      intermediate_size=get("intermediate_size", 3072),
                      max_position_embeddings=get("max_position_embeddings", 512),
                      type_vocab_size=get("type_vocab_size", 2),
                      layer_norm_eps=get("layer_norm_eps", 1e-12),
                      num_labels=len(get("id2label", {0: 0, 1: 1})))


def _family_hf_config(config, family: str) -> dict:
    """The HF ``config.json`` fields :func:`_family_config` reads."""
    c = config
    if family == "vit":
        return dict(image_size=c.image_size, patch_size=c.patch_size,
                    num_channels=c.num_channels, hidden_size=c.hidden_size,
                    num_hidden_layers=c.num_hidden_layers,
                    num_attention_heads=c.num_attention_heads,
                    intermediate_size=c.intermediate_size, layer_norm_eps=c.layer_norm_eps,
                    hidden_dropout_prob=c.hidden_dropout_prob,
                    attention_probs_dropout_prob=c.attention_probs_dropout_prob,
                    hidden_act="gelu", qkv_bias=True,
                    id2label={str(i): f"LABEL_{i}" for i in range(c.num_labels)})
    if family == "t5":
        return dict(vocab_size=c.vocab_size, d_model=c.hidden_size, d_ff=c.intermediate_size,
                    num_layers=c.num_layers, num_decoder_layers=c.num_layers,
                    num_heads=c.num_heads, d_kv=c.head_dim,
                    relative_attention_num_buckets=c.relative_attention_num_buckets,
                    relative_attention_max_distance=c.relative_attention_max_distance,
                    layer_norm_epsilon=c.layer_norm_eps, dropout_rate=c.dropout_rate,
                    feed_forward_proj=c.feed_forward_proj,
                    tie_word_embeddings=c.tie_word_embeddings, is_encoder_decoder=True,
                    decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)
    if family == "gpt2":
        return dict(vocab_size=c.vocab_size, n_embd=c.hidden_size, n_layer=c.num_hidden_layers,
                    n_head=c.num_attention_heads, n_positions=c.max_position_embeddings,
                    layer_norm_epsilon=c.layer_norm_eps, activation_function="gelu_new")
    if family == "opt":
        return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    word_embed_proj_dim=c.hidden_size, ffn_dim=c.intermediate_size,
                    num_hidden_layers=c.num_hidden_layers,
                    num_attention_heads=c.num_attention_heads,
                    max_position_embeddings=c.max_position_embeddings,
                    activation_function=c.activation, do_layer_norm_before=True,
                    tie_word_embeddings=True)
    if family == "gptj":
        return dict(vocab_size=c.vocab_size, n_embd=c.hidden_size, n_inner=c.intermediate_size,
                    n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
                    n_positions=c.max_position_embeddings, rotary_dim=c.rotary_dim,
                    activation_function=c.activation, layer_norm_epsilon=c.layer_norm_eps,
                    tie_word_embeddings=False)
    if family == "phi":
        return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    intermediate_size=c.intermediate_size,
                    num_hidden_layers=c.num_hidden_layers,
                    num_attention_heads=c.num_attention_heads,
                    num_key_value_heads=c.num_key_value_heads,
                    max_position_embeddings=c.max_position_embeddings,
                    partial_rotary_factor=c.partial_rotary_factor, rope_theta=c.rope_theta,
                    hidden_act=c.hidden_act, layer_norm_eps=c.layer_norm_eps,
                    tie_word_embeddings=False)
    if family == "bloom":
        return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
                    layer_norm_epsilon=c.layer_norm_epsilon)
    if family == "gpt_neox":
        return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    intermediate_size=c.intermediate_size,
                    num_hidden_layers=c.num_hidden_layers,
                    num_attention_heads=c.num_attention_heads,
                    max_position_embeddings=c.max_position_embeddings,
                    rotary_pct=c.rotary_pct, rotary_emb_base=c.rope_theta,
                    use_parallel_residual=c.use_parallel_residual, hidden_act=c.hidden_act,
                    layer_norm_eps=c.layer_norm_eps, tie_word_embeddings=False)
    return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                num_hidden_layers=c.num_hidden_layers, num_attention_heads=c.num_attention_heads,
                intermediate_size=c.intermediate_size,
                max_position_embeddings=c.max_position_embeddings,
                type_vocab_size=c.type_vocab_size, layer_norm_eps=c.layer_norm_eps,
                hidden_act="gelu", hidden_dropout_prob=c.hidden_dropout_prob,
                id2label={str(i): f"LABEL_{i}" for i in range(c.num_labels)})


def config_from_hf(hf_config: dict, family: Optional[str] = None):
    """The port's config for an HF ``config.json`` dict: a ``LlamaConfig``
    (a ``MixtralConfig`` for the MoE families), or the GPT-style family's,
    BERT's, ViT's or T5's own config."""
    family = family or detect_family(hf_config)
    _check_family(family)
    get = hf_config.get
    if family in _MODEL_CLASSES:
        return _family_config(family, get)
    if family in ("gemma", "gemma2"):
        # transformers: an absent hidden_activation means the tanh gelu the
        # checkpoints were trained with; an explicit "gelu" is the erf form.
        act = get("hidden_activation") or "gelu_pytorch_tanh"
        if act not in ("gelu", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"hidden_activation {act!r}: the {family} MLP is GeGLU (gelu)")
    else:
        act = get("hidden_act", "silu")
        if act not in ("silu", "swish"):
            raise NotImplementedError(f"hidden_act {act!r}: the {family} MLP is SwiGLU (silu)")
    rope_scaling = get("rope_scaling") or None
    if rope_scaling:
        # An unsupported scaling type must fail now, not at the first forward.
        scale_rope_frequencies(torch.ones(2), rope_scaling)
    kwargs = dict(
        rope_scaling=rope_scaling,
        vocab_size=get("vocab_size", 32000),
        hidden_size=get("hidden_size", 4096),
        intermediate_size=get("intermediate_size", 11008),
        num_hidden_layers=get("num_hidden_layers", 32),
        num_attention_heads=get("num_attention_heads", 32),
        num_key_value_heads=get("num_key_value_heads", get("num_attention_heads", 32)),
        max_position_embeddings=get("max_position_embeddings", 4096),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 10000.0),
        tie_word_embeddings=get("tie_word_embeddings", False),
    )
    if family == "llama":
        return LlamaConfig(**kwargs)
    if family == "mistral":
        return LlamaConfig(**kwargs, sliding_window=get("sliding_window"))
    if family == "qwen2":
        sliding, windows = _qwen_windows(get, kwargs["num_hidden_layers"])
        return LlamaConfig(**kwargs, attention_qkv_bias=True, sliding_window=sliding,
                           layer_windows=windows)
    if family == "mixtral":
        from ..models.mixtral import MixtralConfig

        return MixtralConfig(**kwargs, sliding_window=get("sliding_window"),
                             num_experts=get("num_local_experts", 8),
                             top_k=get("num_experts_per_tok", 2))
    if family == "qwen2_moe":
        # The experts are moe_intermediate_size wide; intermediate_size is
        # the dense layers' width. A layer is sparse iff it is not in
        # mlp_only_layers and (i + 1) % decoder_sparse_step == 0.
        from ..models.mixtral import MixtralConfig

        n = kwargs["num_hidden_layers"]
        step = get("decoder_sparse_step", 1) or 1
        only = set(get("mlp_only_layers") or ())
        sliding, windows = _qwen_windows(get, n)
        return MixtralConfig(
            **{**kwargs, "intermediate_size": get("moe_intermediate_size", 1408)},
            attention_qkv_bias=True, sliding_window=sliding, layer_windows=windows,
            num_experts=get("num_experts", 60), top_k=get("num_experts_per_tok", 4),
            norm_topk_prob=bool(get("norm_topk_prob", False)),
            shared_expert_intermediate_size=get("shared_expert_intermediate_size"),
            mlp_only_layers=tuple(i for i in range(n) if i in only or (i + 1) % step),
            dense_intermediate_size=get("intermediate_size"),
            router_aux_coef=get("router_aux_loss_coef", 0.001))
    gemma = dict(
        {**kwargs, "rms_norm_eps": get("rms_norm_eps", 1e-6),
         "tie_word_embeddings": get("tie_word_embeddings", True)},
        mlp_activation="gelu_tanh" if act == "gelu_pytorch_tanh" else "gelu_exact",
        rms_norm_unit_offset=True, scale_embeddings=True, head_dim_override=get("head_dim"))
    if family == "gemma":
        return LlamaConfig(**gemma)
    if get("layer_types"):
        windows = tuple(get("sliding_window") if t == "sliding_attention" else None
                        for t in get("layer_types"))
    else:  # older configs: even layers slide
        windows = tuple(get("sliding_window") if i % 2 == 0 else None
                        for i in range(kwargs["num_hidden_layers"]))
    return LlamaConfig(**gemma, post_norms=True, layer_windows=windows,
                       attn_logit_softcapping=get("attn_logit_softcapping"),
                       final_logit_softcapping=get("final_logit_softcapping"),
                       query_pre_attn_scalar=get("query_pre_attn_scalar"))


def hf_config_from(config, family: str = "llama") -> dict:
    """The HF ``config.json`` dict of a config (the inverse of
    :func:`config_from_hf` for the fields it reads), for writing a
    checkpoint directory."""
    _check_family(family)
    if family in _MODEL_CLASSES:
        return dict(model_type=family, **_family_hf_config(config, family))
    out = dict(
        model_type=family, vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_key_value_heads,
        max_position_embeddings=config.max_position_embeddings,
        rms_norm_eps=config.rms_norm_eps, rope_theta=config.rope_theta,
        rope_scaling=config.rope_scaling, tie_word_embeddings=config.tie_word_embeddings)
    if family in ("gemma", "gemma2"):
        out["hidden_activation"] = ("gelu_pytorch_tanh" if config.mlp_activation == "gelu_tanh"
                                    else "gelu")
        out["head_dim"] = config.head_dim
    else:
        out["hidden_act"] = "silu"
    if family in ("mistral", "mixtral"):
        out["sliding_window"] = config.sliding_window
    if family == "mixtral":
        out.update(num_local_experts=config.num_experts, num_experts_per_tok=config.top_k)
    if family == "qwen2_moe":
        out.update(moe_intermediate_size=config.intermediate_size,
                   intermediate_size=config.dense_intermediate_size or config.intermediate_size,
                   num_experts=config.num_experts, num_experts_per_tok=config.top_k,
                   norm_topk_prob=bool(config.norm_topk_prob),
                   shared_expert_intermediate_size=config.shared_expert_intermediate_size,
                   decoder_sparse_step=1, mlp_only_layers=list(config.mlp_only_layers),
                   router_aux_loss_coef=config.router_aux_coef)
    windows = [config.window_for(i) for i in range(config.num_hidden_layers)]
    if family in ("qwen2", "qwen2_moe") and any(w is not None for w in windows):
        out["use_sliding_window"] = True
        out["sliding_window"] = next(w for w in windows if w is not None)
        out["layer_types"] = ["full_attention" if w is None else "sliding_attention"
                              for w in windows]
    if family == "gemma2":
        out["sliding_window"] = next((w for w in windows if w is not None), None)
        out["layer_types"] = ["full_attention" if w is None else "sliding_attention"
                              for w in windows]
        out.update(attn_logit_softcapping=config.attn_logit_softcapping,
                   final_logit_softcapping=config.final_logit_softcapping,
                   query_pre_attn_scalar=config.query_pre_attn_scalar)
    return out


def _read_hf_config(checkpoint_dir: str) -> dict:
    path = os.path.join(checkpoint_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{checkpoint_dir} has no config.json; family detection needs it")
    with open(path) as f:
        return json.load(f)


#: The port's model class of each family outside the Llama family and MoE
#: (reference ``model_from_config``, :876-903): (module, class).
_MODEL_CLASSES = {
    "gpt2": ("gpt2", "GPT2LMHeadModel"), "gptj": ("gptj", "GPTJForCausalLM"),
    "gpt_neox": ("gpt_neox", "GPTNeoXForCausalLM"), "bloom": ("bloom", "BloomForCausalLM"),
    "opt": ("opt", "OPTForCausalLM"), "phi": ("phi", "PhiForCausalLM"),
    "bert": ("bert", "BertForSequenceClassification"),
    "vit": ("vit", "ViTForImageClassification"), "t5": ("t5", "T5ForConditionalGeneration"),
}


def model_from_config(config, family: str, device="meta", dtype=torch.float32):
    """The port's model of ``family`` for ``config``; on the meta device by
    default, where it holds no memory (a skeleton for the loaders)."""
    _check_family(family)
    if family in _MODEL_CLASSES:
        import importlib

        module_name, cls = _MODEL_CLASSES[family]
        models = importlib.import_module(f"..models.{module_name}", __package__)
        return getattr(models, cls)(config, device=device, dtype=dtype)
    if family in _EXPERT_CONVENTIONS:
        from ..models.mixtral import MixtralForCausalLM

        return MixtralForCausalLM(config, device=device, dtype=dtype)
    from ..models.llama import LlamaForCausalLM

    return LlamaForCausalLM(config, device=device, dtype=dtype)


def open_hf_checkpoint(checkpoint_dir: str, config=None, dtype=None):
    """Read ``config.json``, detect the family, build (or take) the config,
    and build the model on the meta device: ``(family, config, module)``."""
    hf_config = _read_hf_config(checkpoint_dir)
    family = detect_family(hf_config)
    if config is None:
        config = config_from_hf(hf_config, family)
    return family, config, model_from_config(config, family, dtype=dtype or torch.float32)


def map_hf_key_and_op(key: str, family: str) -> Optional[tuple]:
    """``(the port's name, op)`` of one HF tensor name, or None for a
    rule-less key (a tied head's copy, buffers): the per-tensor form the
    shard-streaming loaders use. ``op`` is None (the tensor as it is),
    ``"t"`` (transposed: the router) or ``"stack:<e>:t"`` (transposed, then
    member ``e`` of the stacked ``[E, in, out]`` leaf the name gives)."""
    _check_family(family)
    key = _strip_prefix(key, family)
    if family in _EXPERT_CONVENTIONS:
        expert_re, leaf_of, _ = _EXPERT_CONVENTIONS[family]
        match = expert_re.match(key)
        if match:
            layer, e, tok = match.groups()
            return f"layers.{layer}.mlp.experts.{leaf_of[tok]}", f"stack:{int(e)}:t"
    for hf_re, _, _, ours_t, op in _COMPILED[family]:
        match = hf_re.match(key)
        if match:
            return _fill(ours_t, match), op
    return None


def _strip_prefix(key: str, family: str) -> str:
    for prefix in _STRIP_PREFIXES.get(family, ()):
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


def map_hf_key(key: str, family: str) -> Optional[str]:
    """The port's name for one HF tensor name (:func:`map_hf_key_and_op`
    without the op), or None."""
    hit = map_hf_key_and_op(key, family)
    return None if hit is None else hit[0]


def apply_op(tensor: torch.Tensor, op: Optional[str]) -> torch.Tensor:
    """``tensor`` under a rule's op: ``"t"`` and ``"stack:<e>:t"``
    transpose a 2-D tensor (the stacking is the caller's), ``"cf"`` flattens
    a conv kernel ``[out, in, kh, kw]`` into ``[out, in*kh*kw]``, None keeps
    it."""
    if op == "cf":
        return tensor.reshape(tensor.shape[0], -1)
    if op is not None and op.endswith("t"):
        return tensor.transpose(0, 1).contiguous()
    return tensor


def stack_members(name: str, parts: dict, count: Optional[int] = None) -> list:
    """The members ``{e: member}`` of the stacked leaf ``name`` in stack
    order; ``count`` (the number of experts, when known) makes a checkpoint
    missing the last ones fail too."""
    n = count if count is not None else max(parts) + 1
    missing = sorted(set(range(n)) - set(parts))
    if missing:
        raise KeyError(f"missing experts {missing} for {name}")
    return [parts[e] for e in range(n)]


def _drop_tied_head(state_dict: dict, family: str) -> bool:
    head = state_dict.get("lm_head.weight")
    embed = state_dict.get(_TIED_EMBEDDING.get(family, "model.embed_tokens.weight"))
    if head is None or embed is None or head.shape != embed.shape:
        return False
    # First row first, so an untied head pays for no full comparison.
    return bool(torch.equal(head[:1], embed[:1]) and torch.equal(head, embed))


def convert_hf_state_dict(state_dict: dict, family: str, *, strict: bool = False) -> dict:
    """HF state dict -> the port's state dict (the same tensors, renamed).
    A head equal to the embedding (a tied checkpoint's copy) is dropped;
    unmatched HF keys are skipped unless ``strict``."""
    _check_family(family)
    drop_head = _drop_tied_head(state_dict, family)
    out, stacked = {}, {}
    for key, value in state_dict.items():
        if drop_head and key == "lm_head.weight":
            continue
        hit = map_hf_key_and_op(key, family)
        if hit is None:
            if strict and not _SKIPPABLE.search(_strip_prefix(key, family)):
                raise KeyError(f"no conversion rule for HF key {key!r} ({family})")
            continue
        name, op = hit
        value = apply_op(torch.as_tensor(value), op)
        if op is not None and op.startswith("stack:"):
            stacked.setdefault(name, {})[int(op.split(":")[1])] = value
        else:
            out[name] = value
    for name, parts in stacked.items():
        router = out.get(name.rsplit(".experts.", 1)[0] + ".router")
        out[name] = torch.stack(stack_members(name, parts,
                                              None if router is None else router.shape[1]))
    return out


def export_hf_state_dict(params, family: str, *, prefix: str = "", config=None,
                         dtype=None) -> dict:
    """The port's state dict (or a model) -> an HF-named state dict of the
    same tensors. Raises on a parameter with no rule, so nothing is dropped
    silently; ``dtype`` casts every floating tensor. ``config`` is needed
    where the export is not fixed by the shapes (ViT's conv kernel: its
    channels and patch size)."""
    _check_family(family)
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    # A gated T5 model's activated projection is wi_0, not v1.0's wi.
    t5_gated = family == "t5" and any(".intermediate_gate." in k for k in params)
    out = {}
    for key, value in params.items():
        if dtype is not None and value.is_floating_point():
            value = value.to(dtype)
        expert = _EXPERT_LEAF.match(key) if family in _EXPERT_CONVENTIONS else None
        if expert is not None:
            _, leaf_of, hf_key_for = _EXPERT_CONVENTIONS[family]
            tok = {v: k for k, v in leaf_of.items()}[expert.group(2)]
            for e in range(value.shape[0]):
                out[prefix + hf_key_for(expert.group(1), e, tok)] = apply_op(value[e], "t")
            continue
        for _, ours_re, hf_t, _, op in _COMPILED[family]:
            match = ours_re.match(key)
            if match:
                hf_key = _fill(hf_t, match)
                if t5_gated and hf_key.endswith(".DenseReluDense.wi.weight"):
                    hf_key = hf_key.replace(".wi.weight", ".wi_0.weight")
                if op == "cf":
                    if config is None:
                        raise ValueError(f"exporting {key!r} needs config= (conv kernel "
                                         "channel/patch factorization)")
                    p = config.patch_size
                    value = value.reshape(value.shape[0], config.num_channels, p, p)
                else:
                    value = apply_op(value, op)
                out[prefix + hf_key] = value
                break
        else:
            raise KeyError(f"no export rule for parameter {key!r} ({family})")
    return out


def load_hf_checkpoint(checkpoint_dir: str, family: Optional[str] = None,
                       config=None, dtype=None):
    """``(config, state_dict)`` of an HF checkpoint directory (one file or
    sharded), CPU tensors cast to ``dtype`` as they are read."""
    from ..checkpointing import checkpoint_shards

    hf_config = {}
    if os.path.exists(os.path.join(checkpoint_dir, "config.json")):
        hf_config = _read_hf_config(checkpoint_dir)
    family = family or detect_family(hf_config)
    config = config or config_from_hf(hf_config, family)
    state_dict = {}
    for shard in checkpoint_shards(checkpoint_dir):
        for key in shard.keys():
            t = shard.read(key)
            state_dict[key] = t if dtype is None else t.to(dtype)
    return config, convert_hf_state_dict(state_dict, family)


def save_hf_checkpoint(params, checkpoint_dir: str, config, family: str = "llama",
                       max_shard_size="5GB", dtype=None) -> None:
    """Write an HF checkpoint directory: ``config.json`` and the weights of
    ``params`` (a state dict or a model, on any device) under HF names, one
    ``model.safetensors`` or shards of at most ``max_shard_size`` with an
    index."""
    from ..checkpointing import save_sharded

    hf = export_hf_state_dict(params, family, config=config, dtype=dtype)
    save_sharded(hf, checkpoint_dir, max_shard_size)
    hf_config = hf_config_from(config, family)
    floating = [t.dtype for t in hf.values() if t.is_floating_point()]
    if floating:
        hf_config["torch_dtype"] = str(floating[0]).removeprefix("torch.")
    with open(os.path.join(checkpoint_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
