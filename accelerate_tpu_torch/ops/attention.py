"""Attention entry points: the Hopper flash kernels on the card, einsum elsewhere.

Counterpart of ``accelerate_tpu/ops/attention.py``. Models dispatch through
:func:`flash_attention`, which takes the hand-written kernels of
``ops/flash_cuda.py`` (forward and backward, through
``FlashAttentionFunction``) for CUDA tensors of a shape they tile, and the
einsum path :func:`_einsum_attention` otherwise (the CPU tests run it).
"""

from __future__ import annotations

import torch

from .flash_cuda import MAX_HEAD_DIM, FlashAttentionFunction

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def flash_attention_available(q) -> bool:
    """True when the flash kernel tiles ``q`` [B, S, H, D]: a CUDA tensor of
    a kernel dtype whose sequence is a positive multiple of 128 and whose
    head_dim is a multiple of 16 no larger than 256 (the JAX gate, with "on
    TPU" read as "on CUDA")."""
    if q.device.type != "cuda" or q.dtype not in _KERNEL_DTYPES:
        return False
    seq, head_dim = q.shape[1], q.shape[-1]
    return seq >= 128 and seq % 128 == 0 and head_dim <= MAX_HEAD_DIM and head_dim % 16 == 0


def softcap_logits(logits, cap):
    """Gemma2-style logit bounding: ``cap * tanh(logits / cap)`` computed in
    f32, returned in the input dtype. ``cap=None`` is the identity."""
    if cap is None:
        return logits
    return (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)


def _einsum_attention(q, k, v, causal: bool, segment_ids=None, sliding_window=None,
                      sm_scale=None, logit_softcap=None):
    """Reference path: [B, S, H, D] -> [B, S, H, D].

    GQA-native: k/v with ``G`` heads (``H = G * rep``) contract grouped
    against the queries, with no repeated copy. ``sliding_window=w`` keeps
    k_pos in (q_pos - w, q_pos]; ``sm_scale`` overrides 1/sqrt(head_dim);
    ``logit_softcap`` bounds logits before the mask (Gemma2)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    B, Sq, H, D = q.shape
    G = k.shape[2]
    if H != G:
        if H % G:
            raise ValueError(f"q heads {H} not a multiple of kv heads {G}")
        qg = (q * scale).reshape(B, Sq, G, H // G, D)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    logits = softcap_logits(logits, logit_softcap)
    head_dims = logits.ndim - 3  # axes between batch and [q, k]
    big_neg = torch.finfo(logits.dtype).min
    if causal or sliding_window is not None:
        q_len, k_len = q.shape[1], k.shape[1]
        q_pos = torch.arange(q_len, device=q.device)[:, None]
        k_pos = torch.arange(k_len, device=q.device)[None, :]
        mask = torch.ones((q_len, k_len), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if sliding_window is not None:
            # Both bounds apply whatever `causal` says: a window never
            # unmasks future keys.
            mask = mask & (k_pos > q_pos - sliding_window) & (k_pos <= q_pos)
        logits = logits.masked_fill(~mask, big_neg)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        seg_mask = seg_mask.reshape(B, *([1] * head_dims), q.shape[1], k.shape[1])
        logits = logits.masked_fill(~seg_mask, big_neg)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if H != G:
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
        return out.reshape(B, Sq, H, D)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128,
                    sliding_window=None, segment_ids=None, sm_scale=None, logit_softcap=None):
    """Flash attention entry point; args are [batch, seq, heads, head_dim].

    Dispatches to the Hopper kernels when :func:`flash_attention_available`
    says they tile ``q``, to the einsum path otherwise. The kernel path is
    differentiable (``FlashAttentionFunction``: the forward kernel, then the
    dK/dV and dQ kernels in the backward). ``segment_ids``,
    ``sliding_window`` (banded: only the band's tiles are visited),
    ``sm_scale`` and ``logit_softcap`` (pre-mask) all run inside the
    kernels. ``block_q`` and ``block_k`` are taken as the JAX entry takes
    them (any size; it clamps them to the sequence) and change nothing:
    each route fixes its tiles in its source (``ops/csrc/``; the wgmma
    forward, for one, takes 128 query rows a block), and the einsum path
    has none."""
    if sliding_window is not None and not causal:
        # Checked here too, so the einsum path fails as the kernel does.
        raise ValueError("sliding_window requires causal=True")
    if not flash_attention_available(q):
        return _einsum_attention(q, k, v, causal, segment_ids=segment_ids,
                                 sliding_window=sliding_window, sm_scale=sm_scale,
                                 logit_softcap=logit_softcap)
    return FlashAttentionFunction.apply(q, k, v, segment_ids, causal, sm_scale, sliding_window,
                                        logit_softcap)
