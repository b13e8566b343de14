"""GPT-NeoX decoder (EleutherAI) in PyTorch.

Counterpart of ``accelerate_tpu/models/gpt_neox.py`` (GPT-NeoX-20B: hidden
6144, 44 layers, 64 heads of 96). A fused QKV projection laid out *per
head* (the output is H blocks of ``[q|k|v]``, reshaped to ``[B, S, H,
3D]`` and split, reference ``:97-98``), partial rotary embeddings over
``rotary_pct`` of each head in the split-half convention, a parallel
residual (``x + attn(ln1(x)) + mlp(ln2(x))``) with the sequential form for
checkpoints trained without it, an untied ``embed_out`` head. Names mirror
the flax tree (``embed_in``, ``layers.<i>.query_key_value``,
``layers.<i>.dense_h_to_4h``, ``final_layer_norm``, ``embed_out``). The
uncached forward attends through the flash kernel: at head_dim 96 the
``mma.sync`` route, on a tile padded to 128 columns.
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
    apply_rotary,
    gelu,
    init_weights,
    multi_head_attention,
    rotary_embedding,
    update_kv_cache_and_attend,
)


@dataclasses.dataclass
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    use_parallel_residual: bool = True
    hidden_act: str = "gelu"   # "gelu"/"gelu_python" = exact erf; gelu_new/fast/pytorch_tanh = tanh
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True
    attention_backend: str = "auto"

    @classmethod
    def neox_20b(cls):
        return cls(hidden_size=6144, intermediate_size=24576,
                   num_hidden_layers=44, num_attention_heads=64)

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
    def rotary_ndims(self):
        """Rotated dims per head: head_dim * rotary_pct."""
        return int(self.head_dim * self.rotary_pct)

    @property
    def num_key_value_heads(self):
        """KV head count (== query heads: no GQA); sizes the KV cache."""
        return self.num_attention_heads


def _partial_rope(x, cos, sin, rot: int):
    """Rotate the first ``rot`` dims of each head (NeoX split-half style),
    pass the rest through."""
    if rot == x.shape[-1]:
        return apply_rotary(x, cos, sin)
    return torch.cat([apply_rotary(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


def _rotary(x, q, k, start: int, rot: int, theta: float):
    """``q`` and ``k`` [B, S, H, D] with positions ``start + i`` rotated
    over their first ``rot`` dims."""
    positions = torch.arange(start, start + q.shape[1], device=q.device)[None]
    cos, sin = rotary_embedding(positions, rot, theta, dtype=x.dtype)
    return _partial_rope(q, cos, sin, rot), _partial_rope(k, cos, sin, rot)


class GPTNeoXBlock(nn.Module):
    """NeoX layer; ``cache``/``cache_pos`` switch to the KV-cached form,
    which returns ``(x, cache)``."""

    def __init__(self, config: GPTNeoXConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=dtype)

        self.input_layernorm = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.query_key_value = linear(H, 3 * H)
        self.dense = linear(H, H)
        self.post_attention_layernorm = LayerNorm(H, cfg.layer_norm_eps, device=device,
                                                  dtype=dtype)
        self.dense_h_to_4h = linear(H, cfg.intermediate_size)
        self.dense_4h_to_h = linear(cfg.intermediate_size, H)

    def forward(self, x, cache=None, cache_pos=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        # HF fuses QKV per head: the output dim is H blocks of [q|k|v] (3D).
        qkv = self.query_key_value(self.input_layernorm(x)).reshape(B, S, H, 3 * D)
        q, k, v = qkv.chunk(3, dim=-1)
        q, k = _rotary(x, q, k, _start_of(cache_pos), cfg.rotary_ndims, cfg.rope_theta)
        if cache is not None:
            attn, cache = update_kv_cache_and_attend(cache, q, k, v, cache_pos, 1)
        else:
            attn = multi_head_attention(q, k, v, causal=True, use_flash=cfg.use_flash_attention,
                                        backend=cfg.attention_backend)
        attn = self.dense(attn.reshape(B, S, H * D))
        h2 = self.post_attention_layernorm(x if cfg.use_parallel_residual else x + attn)
        approximate = cfg.hidden_act not in ("gelu", "gelu_python")
        mlp = self.dense_4h_to_h(gelu(self.dense_h_to_4h(h2), approximate))
        out = x + attn + mlp if cfg.use_parallel_residual else (x + attn) + mlp
        return out if cache is None else (out, cache)


class GPTNeoXForCausalLM(nn.Module):
    """GPT-NeoX causal LM on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``); ``generator`` draws random weights."""

    def __init__(self, config: GPTNeoXConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(GPTNeoXBlock(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device,
                                          dtype=dtype)
        self.embed_out = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=device,
                                   dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, cache=None, cache_pos=None):
        x = self.final_layer_norm(_run_blocks(self.layers, self.embed_in(input_ids), cache,
                                              cache_pos))
        logits = self.embed_out(x)
        return logits if cache is None else (logits, cache)
