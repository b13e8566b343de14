"""Where the benchmark meets the program (``accelerate_tpu_torch``): the
program's configuration built from a configuration file, and the
benchmark's weights put into the program's model under its names."""

from __future__ import annotations

import torch

from . import weights as W

#: The benchmark's weight suffixes -> the program's parameter names in a
#: decoder layer (the Llama and Mixtral modules share the attention names).
_LAYER = {"attn_norm": "input_norm.scale", "mlp_norm": "post_attn_norm.scale",
          "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
          "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
          "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
          "w_down": "mlp.down_proj.weight", "router": "mlp.router",
          "e_gate": "mlp.experts.gate_proj", "e_up": "mlp.experts.up_proj",
          "e_down": "mlp.experts.down_proj"}


def is_moe(cfg: dict) -> bool:
    return "num_local_experts" in cfg


def program_config(cfg: dict, **extra):
    """The program's config object for a configuration file's keys."""
    common = dict(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                  intermediate_size=cfg["intermediate_size"],
                  num_hidden_layers=cfg["num_hidden_layers"],
                  num_attention_heads=cfg["num_attention_heads"],
                  num_key_value_heads=cfg["num_key_value_heads"],
                  max_position_embeddings=cfg["max_position_embeddings"],
                  rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
                  sliding_window=cfg.get("sliding_window"),
                  tie_word_embeddings=cfg["tie_word_embeddings"], **extra)
    if is_moe(cfg):
        from accelerate_tpu_torch.models.mixtral import MixtralConfig

        return MixtralConfig(num_experts=cfg["num_local_experts"],
                             top_k=cfg["num_experts_per_tok"],
                             capacity_factor=cfg["capacity_factor"],
                             router_aux_coef=cfg["router_aux_loss_coef"],
                             router_z_coef=cfg["router_z_loss_coef"], **common)
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**common)


def program_name(cfg: dict, name: str) -> str:
    """The program's parameter name for a benchmark weight name."""
    prefix = "" if is_moe(cfg) else "model."
    if name == "embed":
        return f"{prefix}embed_tokens.weight"
    if name == "final_norm":
        return f"{prefix}norm.scale"
    if name == "head":
        return "lm_head.weight"
    layer, suffix = name.split(".", 1)
    return f"{prefix}layers.{layer[1:]}.{_LAYER[suffix]}"


def build_model(cfg: dict, seed: int, device, dtype, **extra):
    """The program's model for ``cfg`` on ``device`` in ``dtype``, holding
    the benchmark's weights of ``seed`` (made a group at a time and copied
    in)."""
    pcfg = program_config(cfg, **extra)
    if is_moe(cfg):
        from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM as Model
    else:
        from accelerate_tpu_torch.models.llama import LlamaForCausalLM as Model
    model = Model(pcfg, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for group in groups(cfg, seed, device, dtype):
            for name, tensor in group.items():
                params[program_name(cfg, name)].copy_(tensor)
            del group
    return model


def groups(cfg: dict, seed: int, device, dtype):
    """The weights of ``seed``, one group (the two ends, then each layer) at
    a time."""
    yield W.make_ends(cfg, seed, device, dtype)
    for i in range(cfg["num_hidden_layers"]):
        yield W.make_layer(cfg, seed, i, device, dtype)
