"""Plain PyTorch pieces both references share: RMSNorm, rotary embedding
and causal (optionally windowed) attention over one sequence. Float32,
with TF32 off (:func:`exact_f32`)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def exact_f32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` [S, heads, hd] at ``positions`` [S], the
    half-split pairing of the published Mistral/Mixtral code
    (``rotate_half``): frequency ``theta ** (-2i / hd)`` on dims ``i`` and
    ``i + hd / 2``."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd))
    ang = positions.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Optional[int] = None, head_block: int = 8) -> torch.Tensor:
    """Softmax attention of one sequence: ``q`` [S, H, hd], ``k``/``v``
    [S, G, hd] (each key head serves ``H / G`` query heads), query ``i``
    sees keys ``j <= i`` with ``i - j < window``. Scores in blocks of
    ``head_block`` query heads, so one block's [h, S, S] is what is held."""
    S, H, hd = q.shape
    G = k.shape[1]
    rep = H // G
    i = torch.arange(S, device=q.device)
    allowed = i[None, :] <= i[:, None]
    if window is not None:
        allowed = allowed & (i[:, None] - i[None, :] < window)
    outs = []
    for h0 in range(0, H, head_block):
        hs = torch.arange(h0, min(H, h0 + head_block), device=q.device)
        qh = q[:, hs].transpose(0, 1)                         # [h, S, hd]
        kh = k[:, hs // rep].transpose(0, 1)
        vh = v[:, hs // rep].transpose(0, 1)
        scores = (qh @ kh.transpose(1, 2)) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
        outs.append((probs @ vh).transpose(0, 1))               # [S, h, hd]
    return torch.cat(outs, dim=1).reshape(S, H * hd)
