"""Context parallelism: ring attention and Ulysses (all-to-all) attention.

Counterpart of ``accelerate_tpu/ops/ring_attention.py``. The sequence of
every row is split over the mesh's ``cp`` axis: each process holds a
contiguous ``[B, S/cp, H, D]`` chunk of q, k and v (``H`` and ``G`` its
heads, after any ``tp`` split), and the JAX package's global arrays are
these chunks laid end to end in ``cp`` order. The functions here take and
return this process's chunks.

* **Ring attention** (:func:`ring_attention`): the K/V chunks rotate
  around the ``cp`` processes by point-to-point send/recv (one exchange a
  step, K and V together, :class:`_Rotate`, whose backward sends the
  gradient the other way) while an online softmax in f32 (running max,
  denominator and unnormalized output) takes each arriving chunk in
  ``inner_chunk``-wide sub-tiles of keys. The causal mask uses global
  positions. GQA K/V rotate unrepeated (``G`` heads) and contract grouped.
  Each chunk's update is checkpointed, so the backward recomputes its
  tiles (the JAX package's ``jax.checkpoint``). This is plain tensor code,
  as the JAX ring is XLA code (einsum tiles in a ``lax.scan``).
* **Ulysses attention** (:func:`ulysses_attention`): two all-to-alls,
  sequence-split to head-split (``[B, S, H/cp, D]``) and back, around the
  port's flash attention over the whole sequence: the Hopper kernel on the
  card, its plain version on the CPU. Needs heads divisible by ``cp``.

On a ``cp`` axis of one process both are :func:`flash_attention`, as in
the JAX package (``:197``, ``:280``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

_BIG_NEG = -1e30


class _Rotate(torch.autograd.Function):
    """The chunk of the process one place before this one around the
    group's ring; this chunk goes one place on. The backward sends the
    gradient back one place."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.shift(t, 1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.shift(grad, -1), None


class _AllToAll(torch.autograd.Function):
    """``AxisGroup.all_to_all`` (split ``split_dim``, concatenate
    ``concat_dim``); the backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return group.all_to_all(t, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_to_all(grad, ctx.concat_dim, ctx.split_dim), None, None, None


def _tile_update(m, l, o, qf, k_t, v_t, q_pos, k_pos, causal: bool):
    """Online-softmax merge of one ``[B, sub, G, D]`` key/value tile into
    the running max ``m``, denominator ``l`` and output ``o``."""
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, k_t.float())
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, _BIG_NEG))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if causal:
        # Rows masked in the whole tile would add exp(0) = 1 while m_new is
        # still the sentinel.
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, v_t.float())
    return m_new, l_new, o_new


def _block_update(m, l, o, qf, k_c, v_c, q_pos, base, sub: int, causal: bool):
    """One arriving K/V chunk (global offset ``base``), in sub-tiles of
    ``sub`` keys."""
    k_len = k_c.shape[1]
    for start in range(0, k_len, sub):
        k_pos = base + start + torch.arange(sub, device=qf.device)
        m, l, o = _tile_update(m, l, o, qf, k_c[:, start:start + sub], v_c[:, start:start + sub],
                               q_pos, k_pos, causal)
    return m, l, o


def _ring_attention_shard(q, k, v, group, causal: bool, inner_chunk: int):
    """This process's ``[B, S_local, H, D]`` output of ring attention over
    ``group`` (reference ``_ring_attention_shard`` ``:62-157``)."""
    my, n = group.index, group.size
    B, q_len, H, D = q.shape
    k_len, G = k.shape[1], k.shape[2]
    rep = H // G
    scale = D ** -0.5
    q_pos = my * q_len + torch.arange(q_len, device=q.device)
    qf = (q * scale).float().reshape(B, q_len, G, rep, D)
    sub = min(inner_chunk, k_len)
    if k_len % sub:
        sub = k_len
    m = torch.full((B, G, rep, q_len), _BIG_NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, G, rep, q_len), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, G, rep, q_len, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        # After i rotations this process holds the chunk that started i
        # places before it.
        base = ((my - i) % n) * k_len
        k_c, v_c = kv.unbind(0)
        if torch.is_grad_enabled():
            m, l, o = checkpoint(_block_update, m, l, o, qf, k_c, v_c, q_pos, base, sub, causal,
                                 use_reentrant=False)
        else:
            m, l, o = _block_update(m, l, o, qf, k_c, v_c, q_pos, base, sub, causal)
        if i < n - 1:
            kv = _Rotate.apply(kv, group)
    out = o / l.clamp(min=1e-30)[..., None]  # [B, G, rep, q_len, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, q_len, H, D).to(q.dtype)


def _expand_kv(q, k, v):
    """GQA K/V heads repeated to q's: only where a tp axis cannot split the
    ``G`` heads (every attention path is otherwise narrow-KV-native)."""
    if k.shape[2] == q.shape[2]:
        return k, v
    rep = q.shape[2] // k.shape[2]
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def _ambient_inner_chunk() -> int:
    """``ContextParallelPlugin.ring_inner_chunk`` of the live
    ``AcceleratorState``, else the field's default."""
    from ..state import AcceleratorState
    from ..utils.dataclasses import ContextParallelPlugin

    if AcceleratorState._shared_state:
        plugin = AcceleratorState._shared_state.get("cp_plugin")
        if plugin is not None:
            return int(plugin.ring_inner_chunk)
    return ContextParallelPlugin.ring_inner_chunk


def _axis_size(mesh, axis_name: str) -> int:
    return int(mesh.shape[axis_name]) if mesh is not None and axis_name in mesh.shape else 1


def _resolve_mesh(mesh):
    """An explicit mesh, else the ambient one (``state.current_mesh``)."""
    from ..state import current_mesh

    return current_mesh(mesh)


def ring_attention(q, k, v, mesh=None, axis_name: str = "cp", causal: bool = True,
                   inner_chunk: int | None = None):
    """Exact ring attention over the ``axis_name`` axis of ``mesh``
    (default the ambient mesh) on this process's chunks ``[B, S/cp, H, D]``
    (k/v ``[B, S/cp, G, D]``, ``G`` dividing ``H``). ``inner_chunk`` bounds
    the logits tile at ``[B, G, H/G, S/cp, inner_chunk]``; None reads
    ``ContextParallelPlugin.ring_inner_chunk``. A trivial axis is
    :func:`flash_attention`."""
    if inner_chunk is None:
        inner_chunk = _ambient_inner_chunk()
    mesh = _resolve_mesh(mesh)
    axis_size = _axis_size(mesh, axis_name)
    if axis_size == 1:
        from .attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"ring_attention: q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    return _ring_attention_shard(q, k, v, mesh.group(axis_name), causal, inner_chunk)


def ulysses_attention(q, k, v, mesh=None, axis_name: str = "cp", causal: bool = True,
                      use_flash: bool = True):
    """All-to-all (DeepSpeed-Ulysses) attention over the ``axis_name`` axis
    on this process's chunks: heads (q's and k/v's, GQA K/V repeated first
    where they do not divide) must divide by the axis size. A trivial axis
    is :func:`flash_attention`."""
    mesh = _resolve_mesh(mesh)
    axis_size = _axis_size(mesh, axis_name)
    if axis_size == 1:
        from .attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    if k.shape[2] % axis_size:
        k, v = _expand_kv(q, k, v)
    if q.shape[2] % axis_size or k.shape[2] % axis_size:
        raise ValueError(
            f"ulysses_attention: per-tp-shard heads q={q.shape[2]}/kv={k.shape[2]} must be "
            f"divisible by {axis_name}={axis_size} (use ring_attention otherwise)")
    from .attention import _einsum_attention, flash_attention, flash_attention_available

    group = mesh.group(axis_name)
    # [B, S/n, H, D] -> [B, S, H/n, D]: head group j goes to process j, the
    # sequence chunks arrive in process order.
    ql, kl, vl = (_AllToAll.apply(t, group, 2, 1).contiguous() for t in (q, k, v))
    if use_flash and flash_attention_available(ql):
        out = flash_attention(ql, kl, vl, causal=causal)
    else:
        out = _einsum_attention(ql, kl, vl, causal=causal)
    return _AllToAll.apply(out, group, 1, 2)


def context_parallel_attention(q, k, v, mesh=None, axis_name: str = "cp", causal: bool = True,
                               strategy: str = "auto", use_flash: bool = True):
    """Context-parallel attention on this process's chunks. ``strategy``:
    ``"auto"`` (Ulysses when the heads divide by the axis size, else the
    ring; reference ``:338-345``), ``"ring"`` or ``"ulysses"``."""
    mesh = _resolve_mesh(mesh)
    axis_size = _axis_size(mesh, axis_name)
    if strategy == "auto":
        if axis_size > 1 and q.shape[2] % axis_size == 0 and k.shape[2] % axis_size == 0:
            strategy = "ulysses"
        else:
            strategy = "ring"
    if strategy == "ring":
        return ring_attention(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal)
    if strategy == "ulysses":
        return ulysses_attention(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal,
                                 use_flash=use_flash)
    raise ValueError(f"unknown context-parallel strategy {strategy!r}")
