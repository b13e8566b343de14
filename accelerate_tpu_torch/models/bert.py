"""BERT encoder for sequence classification in PyTorch.

Counterpart of ``accelerate_tpu/models/bert.py`` (the model of
``examples/nlp_example.py``; ``BertConfig.base()`` is BERT-base). Names
mirror the flax tree (``encoder.word_embeddings``, ``encoder.embed_norm``,
``encoder.layer.<i>.attention.query``, ``encoder.layer.<i>.attn_norm``,
``encoder.layer.<i>.intermediate``, ``pooler``, ``classifier``). As in the
reference:

* attention is an einsum whose masked logits are ``finfo(dtype).min`` (not
  ``-inf``), the softmax in f32 (reference ``:55-66``); ``use_flash_attention``
  is on the config and nothing reads it;
* the GELU is the tanh approximation (``jax.nn.gelu``'s default, ``:80``),
  and the LayerNorms' eps is 1e-12;
* dropout runs when the loss is given a ``torch.Generator`` (the JAX loss's
  ``rng``), drawn from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .llama import LayerNorm, gelu, init_weights


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    num_labels: int = 2
    use_flash_attention: bool = True  # read by nothing, as in the reference

    @classmethod
    def base(cls, **overrides):
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128, max_position_embeddings=128)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads


def _dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout drawn from ``generator``; the identity without one
    (the deterministic forward) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size
        self.query, self.key, self.value, self.attn_out = (
            nn.Linear(H, H, device=device, dtype=dtype) for _ in range(4))

    def forward(self, x, attention_mask=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        q, k, v = (proj(x).reshape(B, S, H, D) for proj in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q * D ** -0.5, k)
        if attention_mask is not None:
            keep = attention_mask[:, None, None, :].bool()
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H * D)
        return self.attn_out(out)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, device=device, dtype=dtype)
        self.attn_norm = LayerNorm(H, eps, device=device, dtype=dtype)
        self.intermediate = nn.Linear(H, cfg.intermediate_size, device=device, dtype=dtype)
        self.mlp_out = nn.Linear(cfg.intermediate_size, H, device=device, dtype=dtype)
        self.mlp_norm = LayerNorm(H, eps, device=device, dtype=dtype)

    def forward(self, x, attention_mask=None, generator=None):
        rate = self.config.hidden_dropout_prob
        attn = _dropout(self.attention(x, attention_mask), rate, generator)
        x = self.attn_norm(x + attn)
        h = self.mlp_out(gelu(self.intermediate(x), approximate=True))
        return self.mlp_norm(x + _dropout(h, rate, generator))


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H, device=device, dtype=dtype)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H, device=device,
                                                dtype=dtype)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H, device=device,
                                                  dtype=dtype)
        self.embed_norm = LayerNorm(H, cfg.layer_norm_eps, device=device, dtype=dtype)
        self.layer = nn.ModuleList(BertLayer(cfg, device=device, dtype=dtype)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, generator=None):
        cfg = self.config
        S = input_ids.shape[1]
        if S > cfg.max_position_embeddings:
            raise ValueError(f"sequence length {S} runs past BERT's learned position table of "
                             f"{cfg.max_position_embeddings} rows")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(torch.arange(S, device=input_ids.device))[None]
             + self.token_type_embeddings(token_type_ids))
        x = _dropout(self.embed_norm(x), cfg.hidden_dropout_prob, generator)
        for layer in self.layer:
            x = layer(x, attention_mask, generator)
        return x


class BertForSequenceClassification(nn.Module):
    """BERT classifier on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``); ``generator`` draws random weights
    (``llama.init_weights``). ``forward(input_ids, attention_mask=None,
    token_type_ids=None, generator=None)`` gives the logits [B,
    num_labels]; a ``generator`` turns dropout on."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.encoder = BertEncoder(cfg, device=device, dtype=dtype)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device, dtype=dtype)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels, device=device, dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, generator=None):
        x = self.encoder(input_ids, attention_mask, token_type_ids, generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


def classification_loss(model):
    """``loss_fn(params, batch, generator=None)`` for ``compile_train_step``
    and ``backward``: softmax cross-entropy in f32 over ``batch["labels"]``,
    the model run on the parameter tensors ``params`` (by name) through
    ``torch.func.functional_call``. A generator (the accelerator passes
    its own) turns dropout on, as the JAX loss's ``rng`` does."""
    module = getattr(model, "module", model)

    def loss_fn(params, batch, generator=None):
        logits = torch.func.functional_call(
            module, params, (batch["input_ids"], batch.get("attention_mask"),
                             batch.get("token_type_ids")), {"generator": generator})
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, batch["labels"].long()[:, None])[:, 0].mean()

    return loss_fn
