"""GPT-2 decoder in PyTorch: learned positions, pre-LN blocks, a tied head.

Counterpart of ``accelerate_tpu/models/gpt2.py`` (GPT-2 XL: hidden 1600,
48 layers, 25 heads of 64). Module and parameter names mirror the flax tree
(``wte``, ``wpe``, ``h.<i>.qkv``, ``h.<i>.attn_out``, ``h.<i>.fc1``,
``ln_f``), so ``utils/convert.py`` moves weights across by name.

* The uncached forward attends through ``multi_head_attention``: the
  Hopper flash kernel on a CUDA tensor it tiles (head_dim 64 in 16 bits:
  the wgmma route), einsum otherwise. The KV-cached form (``cache=``,
  ``cache_pos=``, what ``generate`` calls) is the shared einsum core of
  ``models/llama.py``.
* The learned position table is checked on the host before its lookup
  (:func:`~.llama._check_learned_positions`).
* The GELU is the tanh approximation (``jax.nn.gelu``'s default,
  reference ``:77``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
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


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True
    attention_backend: str = "auto"  # see llama.multi_head_attention

    @classmethod
    def xl(cls):
        return cls(hidden_size=1600, num_hidden_layers=48, num_attention_heads=25)

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=128)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self):
        """KV head count (== query heads: no GQA); sizes the KV cache."""
        return self.num_attention_heads


class GPT2Block(nn.Module):
    """Pre-LN GPT-2 block; ``cache``/``cache_pos`` switch to the KV-cached
    form, which returns ``(x, cache)``."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size
        self.ln_1 = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.qkv = nn.Linear(H, 3 * H, device=device, dtype=dtype)
        self.attn_out = nn.Linear(H, H, device=device, dtype=dtype)
        self.ln_2 = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.fc1 = nn.Linear(H, 4 * H, device=device, dtype=dtype)
        self.fc2 = nn.Linear(4 * H, H, device=device, dtype=dtype)

    def forward(self, x, cache=None, cache_pos=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        q, k, v = (t.reshape(B, S, H, D) for t in self.qkv(self.ln_1(x)).chunk(3, dim=-1))
        if cache is not None:
            attn, cache = update_kv_cache_and_attend(cache, q, k, v, cache_pos, 1)
        else:
            attn = multi_head_attention(q, k, v, causal=True, use_flash=cfg.use_flash_attention,
                                        backend=cfg.attention_backend)
        x = x + self.attn_out(attn.reshape(B, S, H * D))
        out = x + self.fc2(gelu(self.fc1(self.ln_2(x)), approximate=True))
        return out if cache is None else (out, cache)


class GPT2LMHeadModel(nn.Module):
    """GPT-2 causal LM on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``) in ``dtype``; ``generator`` draws random
    weights (``llama.init_weights``), else load them
    (``state_dict_from_flax``, ``utils/hf_interop.py``)."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, device=device,
                                dtype=dtype)
        self.h = nn.ModuleList(GPT2Block(cfg, device=device, dtype=dtype)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device, dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, cache=None, cache_pos=None):
        cfg = self.config
        start, S = _start_of(cache_pos), input_ids.shape[1]
        _check_learned_positions(start, S, cfg.max_position_embeddings, "GPT-2")
        positions = torch.arange(start, start + S, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(positions)[None]
        x = self.ln_f(_run_blocks(self.h, x, cache, cache_pos))
        logits = x @ self.wte.weight.to(x.dtype).T  # tied head
        return logits if cache is None else (logits, cache)
