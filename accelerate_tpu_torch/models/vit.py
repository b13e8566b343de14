"""Vision Transformer (ViT) for image classification in PyTorch.

Counterpart of ``accelerate_tpu/models/vit.py`` (``ViTConfig.base()`` is
ViT-B/16). Names mirror the flax tree (``patch_projection``, ``cls_token``,
``position_embeddings``, ``layer.<i>.attention.query``,
``layer.<i>.norm_before``, ``layer.<i>.intermediate``, ``norm``,
``classifier``). As in the reference:

* **NHWC input**, as the port's ResNet takes it; the images are cast to the
  weights' dtype.
* **Patches** are one product over :func:`patchify`'s ``(c, ph, pw)``
  feature order, which is torch's ``Conv2d`` weight flattened: an HF conv
  kernel ``[D, C, p, p]`` is this ``Linear``'s weight reshaped.
* **Attention** scales q by ``D**-0.5`` before the einsum and takes the
  softmax in f32; it never reaches the flash kernels (the reference leaves
  it to XLA).
* **The MLP's GELU is the exact erf form** (HF ViT's), unlike BERT's tanh.
* LayerNorms in f32 with eps 1e-12; the classifier reads token 0 after the
  final norm. Dropout runs when the forward is given a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .bert import _dropout
from .llama import LayerNorm, gelu, init_weights


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    num_labels: int = 1000

    @classmethod
    def base(cls, **overrides):
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def tiny(cls, **overrides):
        cfg = cls(image_size=32, patch_size=8, hidden_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, num_labels=10)
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads."""
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self):
        """Patch-token count for the configured image size."""
        return (self.image_size // self.patch_size) ** 2


class ViTSelfAttention(nn.Module):
    def __init__(self, config: ViTConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H = cfg.hidden_size
        self.query, self.key, self.value, self.attn_out = (
            nn.Linear(H, H, device=device, dtype=dtype) for _ in range(4))

    def forward(self, x, generator=None):
        cfg = self.config
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        q, k, v = (proj(x).view(B, S, H, D) for proj in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q * D ** -0.5, k)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        probs = _dropout(probs, cfg.attention_probs_dropout_prob, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H * D)
        return self.attn_out(out)


class ViTBlock(nn.Module):
    def __init__(self, config: ViTConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.norm_before = LayerNorm(H, eps, **kw)
        self.attention = ViTSelfAttention(cfg, **kw)
        self.norm_after = LayerNorm(H, eps, **kw)
        self.intermediate = nn.Linear(H, cfg.intermediate_size, **kw)
        self.mlp_out = nn.Linear(cfg.intermediate_size, H, **kw)

    def forward(self, x, generator=None):
        # HF's placement: dropout after each output projection, none on the
        # intermediate activations.
        rate = self.config.hidden_dropout_prob
        x = x + _dropout(self.attention(self.norm_before(x), generator), rate, generator)
        h = self.mlp_out(gelu(self.intermediate(self.norm_after(x)), approximate=False))
        return x + _dropout(h, rate, generator)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, H, W, C]`` NHWC -> ``[B, (H/p)*(W/p), C*p*p]``, each patch's
    features ordered ``(c, ph, pw)``: torch's ``Conv2d`` weight flattened."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, (H // patch) * (W // patch), C * patch * patch)


class ViTForImageClassification(nn.Module):
    """ViT classifier on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``); ``generator`` draws random weights
    (``llama.init_weights``). ``forward(pixel_values, generator=None)``
    takes NHWC images and gives the logits [B, num_labels]; a
    ``generator`` turns dropout on."""

    def __init__(self, config: ViTConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        D = cfg.hidden_size
        self.patch_projection = nn.Linear(cfg.num_channels * cfg.patch_size ** 2, D, **kw)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, D), **kw))
        self.position_embeddings = nn.Parameter(torch.zeros((1, cfg.num_patches + 1, D), **kw))
        self.layer = nn.ModuleList(ViTBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.norm = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.classifier = nn.Linear(D, cfg.num_labels, **kw)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, pixel_values, generator=None):
        cfg = self.config
        B = pixel_values.shape[0]
        patches = patchify(pixel_values.to(self.patch_projection.weight.dtype), cfg.patch_size)
        x = self.patch_projection(patches)
        cls = self.cls_token.to(x.dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(x.dtype)
        for layer in self.layer:
            x = layer(x, generator)
        return self.classifier(self.norm(x)[:, 0])
