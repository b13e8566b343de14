"""Phi decoder (Microsoft Phi-1/1.5/2) in PyTorch.

Counterpart of ``accelerate_tpu/models/phi.py`` (the defaults are Phi-2:
hidden 2560, 32 layers, 32 heads of 80, ``partial_rotary_factor`` 0.4). One
layer norm feeds attention and the MLP in parallel (GPT-J's residual),
separate biased q/k/v/dense projections with optional GQA, partial rotary
embeddings in the split-half convention (``gpt_neox._partial_rope``) and an
untied, biased head. ``qk_layernorm`` variants are rejected when a
checkpoint's config is read (``utils/hf_interop.py``), as in the
reference. Names mirror the flax tree (``embed_tokens``,
``layers.<i>.input_layernorm``, ``layers.<i>.q_proj``, ``layers.<i>.fc1``,
``final_layernorm``, ``lm_head``). The uncached forward attends through the
flash kernel: at head_dim 80 the ``mma.sync`` route, on a tile padded to
128 columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .gpt_neox import _rotary
from .llama import (
    LayerNorm,
    _run_blocks,
    _start_of,
    gelu,
    init_weights,
    multi_head_attention,
    update_kv_cache_and_attend,
)


@dataclasses.dataclass
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    partial_rotary_factor: float = 0.4
    rope_theta: float = 10000.0
    hidden_act: str = "gelu_new"   # "gelu"/"gelu_python" = exact erf; else tanh
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True
    attention_backend: str = "auto"

    @classmethod
    def phi_2(cls):
        return cls()  # the defaults are phi-2 (2.7B)

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  partial_rotary_factor=0.5)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self):
        """Rotated dims per head: head_dim * partial_rotary_factor."""
        return int(self.head_dim * self.partial_rotary_factor)


class PhiBlock(nn.Module):
    """Phi layer: one LN feeds attention and the MLP in parallel;
    ``cache``/``cache_pos`` switch to the KV-cached form, which returns
    ``(x, cache)``."""

    def __init__(self, config: PhiConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H, D = cfg.hidden_size, cfg.head_dim

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=dtype)

        self.input_layernorm = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.q_proj = linear(H, cfg.num_attention_heads * D)
        self.k_proj = linear(H, cfg.num_key_value_heads * D)
        self.v_proj = linear(H, cfg.num_key_value_heads * D)
        self.dense = linear(cfg.num_attention_heads * D, H)
        self.fc1 = linear(H, cfg.intermediate_size)
        self.fc2 = linear(cfg.intermediate_size, H)

    def forward(self, x, cache=None, cache_pos=None):
        cfg = self.config
        B, S, _ = x.shape
        n_q, n_kv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        h = self.input_layernorm(x)
        q = self.q_proj(h).reshape(B, S, n_q, D)
        k = self.k_proj(h).reshape(B, S, n_kv, D)
        v = self.v_proj(h).reshape(B, S, n_kv, D)
        q, k = _rotary(x, q, k, _start_of(cache_pos), cfg.rotary_ndims, cfg.rope_theta)
        if cache is not None:
            attn, cache = update_kv_cache_and_attend(cache, q, k, v, cache_pos, n_q // n_kv)
        else:
            # GQA K/V unrepeated: the kernel and the einsum path read them by index.
            attn = multi_head_attention(q, k, v, causal=True, use_flash=cfg.use_flash_attention,
                                        backend=cfg.attention_backend)
        attn = self.dense(attn.reshape(B, S, n_q * D))
        approximate = cfg.hidden_act not in ("gelu", "gelu_python")
        mlp = self.fc2(gelu(self.fc1(h), approximate))
        out = x + attn + mlp
        return out if cache is None else (out, cache)


class PhiForCausalLM(nn.Module):
    """Phi causal LM on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``); ``generator`` draws random weights."""

    def __init__(self, config: PhiConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(PhiBlock(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device,
                                         dtype=dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=True, device=device,
                                 dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, cache=None, cache_pos=None):
        x = self.final_layernorm(_run_blocks(self.layers, self.embed_tokens(input_ids), cache,
                                             cache_pos))
        logits = self.lm_head(x)
        return logits if cache is None else (logits, cache)
