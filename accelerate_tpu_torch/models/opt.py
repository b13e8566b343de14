"""OPT decoder (Meta's OPT family) in PyTorch.

Counterpart of ``accelerate_tpu/models/opt.py`` (OPT-30B: hidden 7168, 48
layers, 56 heads of 128, FFN 28672). Against GPT-2: separate biased
q/k/v/out projections, a ReLU (or exact-erf GELU) MLP, and a learned
position table offset by 2 (:data:`POSITION_OFFSET`, an OPT checkpoint
quirk), pre-LN with a final norm and a tied head. Names mirror the flax
tree (``embed_tokens``, ``embed_positions``, ``layers.<i>.q_proj``,
``layers.<i>.self_attn_layer_norm``, ``final_layer_norm``). The uncached
forward attends through the flash kernel (head_dim 128 in 16 bits: the
wgmma route), the cached form through the shared einsum core.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .llama import (
    LayerNorm,
    _check_learned_positions,
    _run_blocks,
    _start_of,
    gelu,
    init_weights,
    multi_head_attention,
    update_kv_cache_and_attend,
)

#: OPT's learned position table starts at index 2 (checkpoint layout quirk).
POSITION_OFFSET = 2


@dataclasses.dataclass
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    activation: str = "relu"
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True
    attention_backend: str = "auto"

    @classmethod
    def opt_30b(cls):
        return cls(hidden_size=7168, intermediate_size=28672,
                   num_hidden_layers=48, num_attention_heads=56)

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=128)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self):
        """KV head count (== query heads: no GQA); sizes the KV cache."""
        return self.num_attention_heads


def _act(cfg: OPTConfig, x):
    if cfg.activation == "relu":
        return F.relu(x)
    # HF "gelu" is the exact erf form (ACT2FN), not the tanh approximation.
    return gelu(x, approximate=False)


class OPTBlock(nn.Module):
    """Pre-LN OPT decoder layer; ``cache``/``cache_pos`` switch to the
    KV-cached form, which returns ``(x, cache)``."""

    def __init__(self, config: OPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=dtype)

        self.self_attn_layer_norm = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (linear(H, H) for _ in range(4))
        self.final_layer_norm = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.fc1 = linear(H, cfg.intermediate_size)
        self.fc2 = linear(cfg.intermediate_size, H)

    def forward(self, x, cache=None, cache_pos=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        h = self.self_attn_layer_norm(x)
        q, k, v = (proj(h).reshape(B, S, H, D) for proj in (self.q_proj, self.k_proj, self.v_proj))
        if cache is not None:
            attn, cache = update_kv_cache_and_attend(cache, q, k, v, cache_pos, 1)
        else:
            attn = multi_head_attention(q, k, v, causal=True, use_flash=cfg.use_flash_attention,
                                        backend=cfg.attention_backend)
        x = x + self.out_proj(attn.reshape(B, S, H * D))
        out = x + self.fc2(_act(cfg, self.fc1(self.final_layer_norm(x))))
        return out if cache is None else (out, cache)


class OPTForCausalLM(nn.Module):
    """OPT causal LM on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``); ``generator`` draws random weights."""

    def __init__(self, config: OPTConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                         dtype=dtype)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + POSITION_OFFSET,
                                            cfg.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(OPTBlock(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device,
                                          dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, cache=None, cache_pos=None):
        cfg = self.config
        start, S = _start_of(cache_pos), input_ids.shape[1]
        _check_learned_positions(start, S, cfg.max_position_embeddings, "OPT")
        positions = torch.arange(POSITION_OFFSET + start, POSITION_OFFSET + start + S,
                                 device=input_ids.device)
        x = self.embed_tokens(input_ids) + self.embed_positions(positions)[None]
        x = self.final_layer_norm(_run_blocks(self.layers, x, cache, cache_pos))
        logits = x @ self.embed_tokens.weight.to(x.dtype).T  # tied head
        return logits if cache is None else (logits, cache)
