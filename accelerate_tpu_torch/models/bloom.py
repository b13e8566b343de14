"""BLOOM decoder (BigScience) in PyTorch: ALiBi position bias, no rotary.

Counterpart of ``accelerate_tpu/models/bloom.py`` (the defaults are
BLOOM-560m: hidden 1024, 24 layers, 16 heads of 64, vocab 250880). Word
embeddings followed by an embedding LayerNorm, pre-LN blocks with a QKV
projection fused *per head* (``[B, S, H, 3, D]``, reference ``:96``), every
projection biased, the ALiBi bias ``slope_h * key_position`` (no position
embeddings of any kind), a tanh-GELU MLP (h -> 4h -> h) and a tied head.
Names mirror the flax tree (``word_embeddings``,
``word_embeddings_layernorm``, ``layers.<i>.query_key_value``, ``ln_f``).

ALiBi rides the shared cached-attention core (``models/llama.py``,
``alibi_slopes``): the bias depends on the key's absolute position only,
so cached decode adds it from the cache's positions. As in the reference
(``:103-107``), no flash kernel runs for this family, cached or not: the
kernel takes no bias, and the uncached forward attends through the same
f32 einsum core over a causal mask.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .llama import (
    LayerNorm,
    _grouped_cached_attention,
    _run_blocks,
    gelu,
    init_weights,
    update_kv_cache_and_attend,
)


@dataclasses.dataclass
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_epsilon: float = 1e-5
    # ALiBi needs no position table: no bound on positions.
    max_position_embeddings: Optional[int] = None
    sliding_window: Optional[int] = None  # full-length KV caches

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads

    @property
    def intermediate_size(self):
        """BLOOM's MLP is a fixed 4x expansion."""
        return 4 * self.hidden_size

    @property
    def num_key_value_heads(self):
        """KV head count (no GQA); sizes the KV cache."""
        return self.num_attention_heads


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes [n_heads] f32, the HF/paper formula with the
    non-power-of-two interleave: the closest power of two gets the
    geometric ladder 2^(-8/n), the extra heads the odd steps of the 2n
    ladder."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest < n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** (2 * i + 1) for i in range(n_heads - closest)]
    return torch.tensor(slopes, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """:func:`alibi_slopes` on ``device``, copied there once."""
    return alibi_slopes(n_heads).to(device)


class BloomBlock(nn.Module):
    """BLOOM layer; ``cache``/``cache_pos`` switch to the KV-cached form,
    which returns ``(x, cache)``."""

    def __init__(self, config: BloomConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=dtype)

        self.input_layernorm = LayerNorm(H, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.query_key_value = linear(H, 3 * H)
        self.dense = linear(H, H)
        self.post_attention_layernorm = LayerNorm(H, cfg.layer_norm_epsilon, device=device,
                                                  dtype=dtype)
        self.dense_h_to_4h = linear(H, cfg.intermediate_size)
        self.dense_4h_to_h = linear(cfg.intermediate_size, H)

    def forward(self, x, cache=None, cache_pos=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        slopes = _slopes_on(H, x.device)
        # HF fuses QKV per head: view(B, S, H, 3, D).
        qkv = self.query_key_value(self.input_layernorm(x)).reshape(B, S, H, 3, D)
        q, k, v = qkv.unbind(dim=3)
        if cache is not None:
            attn, cache = update_kv_cache_and_attend(cache, q, k, v, cache_pos, 1,
                                                     alibi_slopes=slopes)
        else:
            pos = torch.arange(S, device=x.device)
            mask = pos[None, :] <= pos[:, None]  # causal [S, S]
            attn = _grouped_cached_attention(q, k.transpose(1, 2), v.transpose(1, 2), mask[None],
                                             1, alibi_slopes=slopes, k_positions=pos)
        x = x + self.dense(attn.reshape(B, S, H * D))
        # BloomGelu is the tanh approximation.
        mlp = self.dense_4h_to_h(gelu(self.dense_h_to_4h(self.post_attention_layernorm(x)),
                                      approximate=True))
        out = x + mlp
        return out if cache is None else (out, cache)


class BloomForCausalLM(nn.Module):
    """BLOOM causal LM on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``); ``generator`` draws random weights."""

    def __init__(self, config: BloomConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                            dtype=dtype)
        self.word_embeddings_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                                                   device=device, dtype=dtype)
        self.layers = nn.ModuleList(BloomBlock(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, device=device,
                              dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, cache=None, cache_pos=None):
        x = self.word_embeddings_layernorm(self.word_embeddings(input_ids))
        x = self.ln_f(_run_blocks(self.layers, x, cache, cache_pos))
        logits = x @ self.word_embeddings.weight.to(x.dtype).T  # tied head
        return logits if cache is None else (logits, cache)
