"""Memory-efficient LM-head cross-entropy, chunked over the vocabulary.

Counterpart of ``accelerate_tpu/ops/fused_loss.py``. The plain causal-LM
loss materializes ``[tokens, vocab]`` logits twice (the head's product and
the f32 softmax); at the tier-1 config (8 x 1024 tokens, vocab 32000) that
is ~1 GB of f32 a pass. :func:`chunked_softmax_xent` never forms them: a
loop over vocabulary chunks keeps a running (max, sum-exp, target-logit)
triple per token, an online softmax over the vocab dim, and the backward
recomputes each chunk's logits to emit ``dh`` and ``dW`` chunk by chunk.
Peak activation memory drops from O(tokens x vocab) to O(tokens x vocab /
num_chunks); the products are the same.

The JAX version is an XLA ``scan`` (no Pallas kernel), so plain torch is its
counterpart: the chunk products are ``torch.mm``. Logits accumulate in f32
as JAX's ``preferred_element_type`` does: on the card a 16-bit product
returns f32 directly (``torch.mm(..., out_dtype=torch.float32)``), so the
head runs at the tensor cores' 16-bit rate, not the f32 rate; on the CPU the
16-bit operands are upcast first. In the backward, with 16-bit inputs, the
f32 ``dlogits`` is rounded to the input dtype before its two products (also
with f32 results), so they too run at the 16-bit rate; float32 inputs keep
every product in f32, as the JAX version does.
"""

from __future__ import annotations

import torch


def _mm_f32(a, b):
    """``a @ b`` accumulated and returned in f32 (float64 stays float64)."""
    if a.dtype in (torch.float32, torch.float64):
        return a @ b.to(a.dtype)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _softcapped(logits, logit_softcap):
    if logit_softcap is None:
        return logits
    return logit_softcap * torch.tanh(logits / logit_softcap)


def _chunks(V: int, num_chunks: int):
    if V % num_chunks:
        raise ValueError(f"vocab {V} not divisible by num_chunks {num_chunks}")
    C = V // num_chunks
    return C, [slice(c * C, (c + 1) * C) for c in range(num_chunks)]


class _ChunkedSoftmaxXent(torch.autograd.Function):
    """The custom VJP of ``chunked_softmax_xent`` (``_fwd`` / ``_bwd`` of the
    JAX version)."""

    @staticmethod
    def forward(ctx, h, kernel, targets, mask, num_chunks, logit_softcap):
        N = h.shape[0]
        C, chunks = _chunks(kernel.shape[1], num_chunks)
        acc = torch.promote_types(h.dtype, torch.float32)
        m = torch.full((N,), float("-inf"), dtype=acc, device=h.device)
        l = torch.zeros((N,), dtype=acc, device=h.device)
        t = torch.zeros((N,), dtype=acc, device=h.device)
        for c, cols in enumerate(chunks):
            logits = _softcapped(_mm_f32(h, kernel[:, cols]), logit_softcap)  # [N, C]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = targets - c * C
            in_chunk = (local >= 0) & (local < C)
            picked = logits.gather(1, local.clamp(0, C - 1)[:, None])[:, 0]
            t = t + torch.where(in_chunk, picked, torch.zeros_like(picked))
        lse = m + torch.log(l)
        denom = mask.to(acc).sum().clamp(min=1.0)
        loss = ((lse - t) * mask.to(acc)).sum() / denom
        ctx.save_for_backward(h, kernel, targets, mask, lse, denom)
        ctx.num_chunks, ctx.logit_softcap = num_chunks, logit_softcap
        return loss

    @staticmethod
    def backward(ctx, g):
        h, kernel, targets, mask, lse, denom = ctx.saved_tensors
        cap = ctx.logit_softcap
        C, chunks = _chunks(kernel.shape[1], ctx.num_chunks)
        acc = lse.dtype
        # d(loss)/d(logit_ic) = (softmax_ic - onehot_ic) * mask_i / denom * g
        scale = (g.to(acc) * mask.to(acc) / denom)[:, None]  # [N, 1]
        dh = torch.zeros(h.shape, dtype=acc, device=h.device)
        dkernel = torch.empty_like(kernel)
        for c, cols in enumerate(chunks):
            w_c = kernel[:, cols]
            logits = _softcapped(_mm_f32(h, w_c), cap)  # recomputed [N, C]
            dlogits = torch.exp(logits - lse[:, None])
            local = targets - c * C
            in_chunk = ((local >= 0) & (local < C)).to(acc)
            dlogits.scatter_add_(1, local.clamp(0, C - 1)[:, None], -in_chunk[:, None])
            dlogits = dlogits * scale
            if cap is not None:
                # chain d(cap * tanh(pre / cap)) = 1 - (post / cap)^2, with the
                # bounded post-cap logits: the factor is in [0, 1].
                dlogits = dlogits * (1.0 - torch.square(logits / cap))
            dlogits = dlogits.to(h.dtype) if h.dtype.itemsize < 4 else dlogits
            dh += _mm_f32(dlogits, w_c.T)
            dkernel[:, cols] = _mm_f32(h.T, dlogits).to(kernel.dtype)
        return dh.to(h.dtype), dkernel, None, None, None, None


def chunked_softmax_xent(h, kernel, targets, mask, num_chunks: int = 8,
                         logit_softcap: float | None = None):
    """Mean masked cross-entropy of ``softmax(h @ kernel)`` against ``targets``.

    Args:
      h: [N, H] hidden states (any float dtype; logits accumulate in f32).
      kernel: [H, V] head weights (the flax layout; pass ``weight.T`` of an
        ``nn.Linear``). ``num_chunks`` must divide V.
      targets: [N] int class ids (already made safe: no -100 sentinels).
      mask: [N] float weights (0 drops a token).
      num_chunks: vocab tiles; more means less memory, the same products.
      logit_softcap: Gemma2 final-logit bounding, applied per chunk inside
        the online softmax (cap * tanh(logit / cap)); the backward chains
        the tanh derivative through the recomputed chunk.

    Returns the scalar ``sum(nll * mask) / max(sum(mask), 1)`` in f32.
    """
    return _ChunkedSoftmaxXent.apply(h, kernel, targets, mask, num_chunks, logit_softcap)
