"""GPT-J decoder (EleutherAI 6B) in PyTorch.

Counterpart of ``accelerate_tpu/models/gptj.py`` (the defaults are
GPT-J-6B: hidden 4096, 28 layers, 16 heads of 256, ``rotary_dim`` 64).
Partial rotary embeddings in the *interleaved* ("rotate every two")
convention, not the split halves of Llama and NeoX; one layer norm feeds
attention and the MLP in parallel (``x + attn(ln(x)) + mlp(ln(x))``);
unbiased attention projections; an untied, biased head. Names mirror the
flax tree (``wte``, ``h.<i>.ln_1``, ``h.<i>.q_proj``, ``h.<i>.fc_in``,
``ln_f``, ``lm_head``). The uncached forward attends through the flash
kernel: at head_dim 256 the ``mma.sync`` route (wgmma takes 64 and 128
only), the cached form through the shared einsum core.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .llama import (
    LayerNorm,
    _run_blocks,
    _start_of,
    gelu,
    init_weights,
    multi_head_attention,
    rotary_embedding,
    update_kv_cache_and_attend,
)


@dataclasses.dataclass
class GPTJConfig:
    vocab_size: int = 50400
    hidden_size: int = 4096
    intermediate_size: int = 16384
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    rotary_dim: int = 64
    activation: str = "gelu_new"   # "gelu"/"gelu_python" = exact erf; gelu_new/fast/pytorch_tanh = tanh
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True
    attention_backend: str = "auto"

    @classmethod
    def gptj_6b(cls):
        return cls()  # the defaults are GPT-J-6B

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=128, rotary_dim=8)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self):
        """KV head count (== query heads: no GQA); sizes the KV cache."""
        return self.num_attention_heads


def apply_rotary_interleaved(x, cos, sin):
    """GPT-J's "rotate every two" RoPE: pairs are (x[2i], x[2i+1]), not the
    split halves Llama and NeoX use. cos/sin: [..., seq, dim//2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def _partial_rope_interleaved(x, cos, sin, rot: int):
    if rot == x.shape[-1]:
        return apply_rotary_interleaved(x, cos, sin)
    return torch.cat([apply_rotary_interleaved(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


class GPTJBlock(nn.Module):
    """GPT-J layer: one LN feeds attention and the MLP in parallel;
    ``cache``/``cache_pos`` switch to the KV-cached form, which returns
    ``(x, cache)``."""

    def __init__(self, config: GPTJConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size

        def linear(n_in, n_out, bias):
            return nn.Linear(n_in, n_out, bias=bias, device=device, dtype=dtype)

        self.ln_1 = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (linear(H, H, False)
                                                                for _ in range(4))
        self.fc_in = linear(H, cfg.intermediate_size, True)
        self.fc_out = linear(cfg.intermediate_size, H, True)

    def forward(self, x, cache=None, cache_pos=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        h = self.ln_1(x)
        q, k, v = (proj(h).reshape(B, S, H, D) for proj in (self.q_proj, self.k_proj, self.v_proj))
        start = _start_of(cache_pos)
        positions = torch.arange(start, start + S, device=x.device)[None]
        rot = cfg.rotary_dim
        cos, sin = rotary_embedding(positions, rot, 10000.0, dtype=x.dtype)
        q = _partial_rope_interleaved(q, cos, sin, rot)
        k = _partial_rope_interleaved(k, cos, sin, rot)
        if cache is not None:
            attn, cache = update_kv_cache_and_attend(cache, q, k, v, cache_pos, 1)
        else:
            attn = multi_head_attention(q, k, v, causal=True, use_flash=cfg.use_flash_attention,
                                        backend=cfg.attention_backend)
        attn = self.out_proj(attn.reshape(B, S, H * D))
        approximate = cfg.activation not in ("gelu", "gelu_python")
        mlp = self.fc_out(gelu(self.fc_in(h), approximate))
        out = x + attn + mlp
        return out if cache is None else (out, cache)


class GPTJForCausalLM(nn.Module):
    """GPT-J causal LM on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``); ``generator`` draws random weights."""

    def __init__(self, config: GPTJConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.h = nn.ModuleList(GPTJBlock(cfg, device=device, dtype=dtype)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=True, device=device,
                                 dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, cache=None, cache_pos=None):
        x = self.ln_f(_run_blocks(self.h, self.wte(input_ids), cache, cache_pos))
        logits = self.lm_head(x)
        return logits if cache is None else (logits, cache)
