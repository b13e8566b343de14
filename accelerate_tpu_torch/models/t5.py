"""T5 encoder-decoder in PyTorch.

Counterpart of ``accelerate_tpu/models/t5.py`` (T0pp-11B, the encoder-decoder
row of the upstream big-model benchmark, is :meth:`T5Config.t0pp`). Module
and parameter names mirror the flax tree (``shared_embedding``,
``encoder_layer.<i>.attention.query``, ``encoder_layer.<i>.mlp.intermediate``,
``decoder_layer.<i>.cross_attention``, ``encoder_norm``, ``lm_head``), so
``utils/convert.py`` moves weights across by name. As in the reference:

* **Relative position bias.** Layer 0 of each stack looks its bias up from
  its bucket table and the later layers reuse it; cross-attention has none.
  :func:`relative_position_bucket` is the reference's float32 formula,
  ``log(n / max_exact + 1e-6)`` truncated to int32 (HF's has no ``1e-6``).
* **Attention** is an einsum with no ``1/sqrt(d)`` on q; the bias is added,
  then masked keys are *replaced* by ``finfo(float32).min`` and the softmax
  is taken in f32 (a fully masked pad row comes out uniform, not NaN). It
  never reaches the flash kernels, as the reference leaves it to XLA
  (``use_flash_attention`` is False and nothing reads it).
* **Cached decode** (``mode="decode"``): self-attention writes the step's
  K/V into ``[B, max_len, H, D]`` buffers at ``cache_pos`` (in place) and
  masks by absolute position; its bias is looked up for the true query
  positions over the whole buffer. The cross K/V are computed at prefill and
  passed back unchanged.
* **Head.** Tied (v1.0): ``(y * d_model**-0.5) @ E^T``; untied (v1.1/flan,
  T0pp): a plain ``lm_head``.
* **MLP.** ``relu``, or gated: ``act(intermediate) * intermediate_gate``
  with the tanh GELU (``jax.nn.gelu``'s default) or SiLU.
* **Dropout** follows the embedding, each sublayer, the attention
  probabilities, the MLP hidden and both final norms; it runs when the
  forward is given a ``torch.Generator`` (the JAX loss's ``rng``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .bert import _dropout
from .llama import gelu, init_weights


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 6           # encoder layers (the decoder has as many)
    num_heads: int = 8
    head_dim: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout_rate: float = 0.1
    # "relu" (t5 v1.0: wi/wo) or "gated-gelu"/"gated-silu" (v1.1/flan).
    feed_forward_proj: str = "relu"
    # v1.0 ties the head to the shared embedding (with a 1/sqrt(d) rescale);
    # v1.1/flan use a separate lm_head and no rescale.
    tie_word_embeddings: bool = True
    use_flash_attention: bool = False  # read by nothing, as in the reference

    @classmethod
    def small(cls, **overrides):
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, head_dim=16,
                  relative_attention_num_buckets=8, relative_attention_max_distance=32)
        return dataclasses.replace(cfg, **overrides)

    @classmethod
    def t0pp(cls, **overrides):
        """T0pp-11B (bigscience/T0pp, the t5-v1.1-xxl-lm-adapt shape): 24 + 24
        layers, d_model 4096, 64 heads of 64, d_ff 10240, gated GELU, an
        untied head."""
        cfg = cls(vocab_size=32128, hidden_size=4096, intermediate_size=10240, num_layers=24,
                  num_heads=64, head_dim=64, feed_forward_proj="gated-gelu",
                  tie_word_embeddings=False)
        return dataclasses.replace(cfg, **overrides)


class T5LayerNorm(nn.Module):
    """T5's RMS norm in f32: no mean subtraction, no bias."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale.float()).to(x.dtype)


def relative_position_bucket(relative_position, bidirectional: bool, num_buckets: int,
                             max_distance: int):
    """T5's log-bucketed relative positions (int tensor in, same dtype out),
    the reference's float32 arithmetic step for step."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scaled = torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact)
    val_if_large = max_exact + (scaled * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1).to(ret.dtype)
    return ret + torch.where(is_small, n, val_if_large)


_BIG_NEG = torch.finfo(torch.float32).min


class T5Attention(nn.Module):
    """Self-attention (``kv`` and ``cross_kv`` None) or cross-attention. Returns
    ``(out, position_bias)``, with a third item in the cached and the
    cross-K/V forms (the reference's ``__call__``): the updated self cache,
    or the cross ``(k, v)`` computed with ``return_cross_kv``."""

    def __init__(self, config: T5Config, causal: bool = False, has_relative_bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.causal, self.has_relative_bias = causal, has_relative_bias
        inner = cfg.num_heads * cfg.head_dim
        self.query, self.key, self.value = (
            nn.Linear(cfg.hidden_size, inner, bias=False, device=device, dtype=dtype)
            for _ in range(3))
        self.attn_out = nn.Linear(inner, cfg.hidden_size, bias=False, device=device, dtype=dtype)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, device=device, dtype=dtype)

    def _relative_bias(self, q_positions, k_len: int):
        """[1, H, S_q, S_k] f32 bias for arbitrary query positions (prefill
        0..S-1, cached decode ``cache_pos``..)."""
        cfg = self.config
        rel = torch.arange(k_len, device=q_positions.device)[None, :] - q_positions[:, None]
        buckets = relative_position_bucket(
            rel, bidirectional=not self.causal, num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).float().permute(2, 0, 1)[None]

    def forward(self, x, kv=None, mask=None, position_bias=None, cache=None, cache_pos=None,
                cross_kv=None, return_cross_kv=False, generator=None):
        cfg = self.config
        B, S_q, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = self.query(x).view(B, S_q, H, D)
        extra = None
        if cross_kv is not None:
            k, v = cross_kv
        else:
            source = x if kv is None else kv
            S_k = source.shape[1]
            k = self.key(source).view(B, S_k, H, D)
            v = self.value(source).view(B, S_k, H, D)
            if return_cross_kv:
                extra = (k, v)

        causal_mask = None
        if cache is not None:
            # The step's K/V go into the buffers at cache_pos; attention runs
            # over the whole buffer, future slots masked by absolute position.
            cache["k"][:, cache_pos:cache_pos + S_q] = k.to(cache["k"].dtype)
            cache["v"][:, cache_pos:cache_pos + S_q] = v.to(cache["v"].dtype)
            k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            extra = cache
            q_positions = cache_pos + torch.arange(S_q, device=x.device)
            causal_mask = torch.arange(k.shape[1], device=x.device)[None, :] <= q_positions[:, None]
        else:
            q_positions = torch.arange(S_q, device=x.device)
            if self.causal:
                causal_mask = q_positions[:, None] >= torch.arange(k.shape[1],
                                                                   device=x.device)[None, :]

        # No 1/sqrt(d) on q: T5 folds it into the initialisation.
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if position_bias is None and self.has_relative_bias:
            position_bias = self._relative_bias(q_positions, k.shape[1])
        if position_bias is not None:
            logits = logits + position_bias
        if causal_mask is not None:
            logits = logits.masked_fill(~causal_mask[None, None], _BIG_NEG)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :].bool(), _BIG_NEG)
        probs = _dropout(torch.softmax(logits, dim=-1).to(x.dtype), cfg.dropout_rate, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S_q, H * D)
        out = self.attn_out(out)
        if cache is not None or cross_kv is not None or return_cross_kv:
            return out, position_bias, extra
        return out, position_bias


class T5MLP(nn.Module):
    def __init__(self, config: T5Config, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        proj = cfg.feed_forward_proj
        if proj not in ("relu", "gated-gelu", "gated-silu"):
            raise NotImplementedError(f"feed_forward_proj {proj!r}")
        kw = dict(bias=False, device=device, dtype=dtype)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        if proj.startswith("gated-"):
            self.intermediate_gate = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x, generator=None):
        proj = self.config.feed_forward_proj
        if proj == "relu":
            h = F.relu(self.intermediate(x))
        else:
            pre = self.intermediate(x)
            act = gelu(pre, approximate=True) if proj == "gated-gelu" else F.silu(pre)
            h = act * self.intermediate_gate(x)
        return self.mlp_out(_dropout(h, self.config.dropout_rate, generator))


class T5EncoderBlock(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.attention = T5Attention(cfg, causal=False, has_relative_bias=has_relative_bias, **kw)
        self.attn_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = T5MLP(cfg, **kw)
        self.mlp_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, x, mask=None, position_bias=None, generator=None):
        rate = self.config.dropout_rate
        attn, position_bias = self.attention(self.attn_norm(x), mask=mask,
                                             position_bias=position_bias, generator=generator)
        x = x + _dropout(attn, rate, generator)
        x = x + _dropout(self.mlp(self.mlp_norm(x), generator), rate, generator)
        return x, position_bias


class T5DecoderBlock(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.self_attention = T5Attention(cfg, causal=True, has_relative_bias=has_relative_bias,
                                          **kw)
        self.self_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.cross_attention = T5Attention(cfg, causal=False, **kw)
        self.cross_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = T5MLP(cfg, **kw)
        self.mlp_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, x, enc, self_mask=None, cross_mask=None, position_bias=None, cache=None,
                cache_pos=None, cross_kv=None, generator=None):
        """``(x, position_bias)``; with ``cache``, ``(x, position_bias,
        cache, cross_kv)``, the cross K/V computed from ``enc`` when
        ``cross_kv`` is None (the prefill) and passed back as given after."""
        rate = self.config.dropout_rate
        normed = self.self_norm(x)
        if cache is not None:
            attn, position_bias, cache = self.self_attention(
                normed, mask=self_mask, position_bias=position_bias, cache=cache,
                cache_pos=cache_pos, generator=generator)
        else:
            attn, position_bias = self.self_attention(normed, mask=self_mask,
                                                      position_bias=position_bias,
                                                      generator=generator)
        x = x + _dropout(attn, rate, generator)
        cross_in = self.cross_norm(x)
        if cache is None:
            cross, _ = self.cross_attention(cross_in, kv=enc, mask=cross_mask, generator=generator)
        elif cross_kv is None:
            cross, _, cross_kv = self.cross_attention(cross_in, kv=enc, mask=cross_mask,
                                                      return_cross_kv=True, generator=generator)
        else:
            cross, _, _ = self.cross_attention(cross_in, mask=cross_mask, cross_kv=cross_kv,
                                               generator=generator)
        x = x + _dropout(cross, rate, generator)
        x = x + _dropout(self.mlp(self.mlp_norm(x), generator), rate, generator)
        if cache is not None:
            return x, position_bias, cache, cross_kv
        return x, position_bias


class T5ForConditionalGeneration(nn.Module):
    """T5 on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``); ``generator`` draws random weights
    (``llama.init_weights``).

    ``forward(input_ids, decoder_input_ids, attention_mask,
    decoder_attention_mask, mode=..., encoder_out=, cache=, cache_pos=,
    cross_kv=, generator=)``: ``mode="train"`` (the default) runs the whole
    teacher-forced forward -> logits [B, S_dec, V]; ``"encode"`` the encoder
    -> [B, S_enc, D]; ``"decode"`` one cached decoder step over
    ``encoder_out`` -> ``(logits, cache, cross_kv)``, the first call
    (``cross_kv=None``) computing each layer's cross K/V. A ``generator``
    turns dropout on."""

    def __init__(self, config: T5Config, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.shared_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.encoder_layer = nn.ModuleList(T5EncoderBlock(cfg, has_relative_bias=i == 0, **kw)
                                           for i in range(cfg.num_layers))
        self.encoder_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.decoder_layer = nn.ModuleList(T5DecoderBlock(cfg, has_relative_bias=i == 0, **kw)
                                           for i in range(cfg.num_layers))
        self.decoder_norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw)
        if generator is not None:
            init_weights(self, generator)

    def encode(self, input_ids, attention_mask=None, generator=None):
        """The encoder stack: relative bias from layer 0, shared onward."""
        rate = self.config.dropout_rate
        x = _dropout(self.shared_embedding(input_ids), rate, generator)
        bias = None
        for layer in self.encoder_layer:
            x, bias = layer(x, attention_mask, bias, generator)
        return _dropout(self.encoder_norm(x), rate, generator)

    def head(self, y):
        """Logits of the final decoder states (already normed)."""
        if self.config.tie_word_embeddings:
            # T5's 1/sqrt(d) rescale exists only in the tied variant.
            embedding = self.shared_embedding.weight.to(y.dtype)
            return (y * self.config.hidden_size ** -0.5) @ embedding.T
        return self.lm_head(y)

    def forward(self, input_ids=None, decoder_input_ids=None, attention_mask=None,
                decoder_attention_mask=None, mode: str = "train", encoder_out=None, cache=None,
                cache_pos=None, cross_kv=None, generator=None):
        rate = self.config.dropout_rate
        enc = encoder_out
        if mode in ("train", "encode"):
            enc = self.encode(input_ids, attention_mask, generator)
            if mode == "encode":
                return enc
        elif mode != "decode":
            raise ValueError(f"mode must be 'train', 'encode' or 'decode' (got {mode!r})")
        decoding = mode == "decode"
        y = _dropout(self.shared_embedding(decoder_input_ids), rate, generator)
        bias = None
        new_cross = []
        for i, layer in enumerate(self.decoder_layer):
            if decoding:
                y, bias, _, layer_ckv = layer(
                    y, enc, decoder_attention_mask, attention_mask, bias, cache=cache[i],
                    cache_pos=cache_pos, cross_kv=None if cross_kv is None else cross_kv[i],
                    generator=generator)
                new_cross.append(layer_ckv)
            else:
                y, bias = layer(y, enc, decoder_attention_mask, attention_mask, bias,
                                generator=generator)
        logits = self.head(_dropout(self.decoder_norm(y), rate, generator))
        if decoding:
            return logits, cache, tuple(new_cross)
        return logits

    def init_decode_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16):
        """Per-decoder-layer self-attention buffers ``{"k", "v"}`` of
        ``[B, max_len, H, D]`` on the model's device (written in place)."""
        cfg = self.config
        shape = (batch_size, max_len, cfg.num_heads, cfg.head_dim)
        device = self.shared_embedding.weight.device
        return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
                     for _ in range(cfg.num_layers))


def seq2seq_lm_loss(model):
    """``loss_fn(params, batch, generator=None)`` for ``compile_train_step``
    and ``backward``: teacher-forced cross-entropy in f32. The batch holds
    ``input_ids`` and ``labels``, optionally ``attention_mask`` and
    ``decoder_attention_mask`` (which also weights the loss); the decoder
    input is ``labels`` shifted right behind a 0 (T5's start token). A
    generator (the accelerator passes its own) turns dropout on."""
    module = getattr(model, "module", model)

    def loss_fn(params, batch, generator=None):
        labels = batch["labels"].long()
        decoder_input_ids = F.pad(labels[:, :-1], (1, 0))
        mask = batch.get("decoder_attention_mask")
        logits = torch.func.functional_call(
            module, params, (batch["input_ids"], decoder_input_ids, batch.get("attention_mask"),
                             mask), {"generator": generator})
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels[..., None])[..., 0]
        if mask is not None:
            return (nll * mask).sum() / mask.sum().clamp(min=1)
        return nll.mean()

    return loss_fn

