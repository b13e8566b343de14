"""The port's flash-attention backward against the JAX package's.

``flash_bwd_reference`` (the plain version the two Hopper backward kernels
are held to on the card) is compared with the Pallas backward ``_flash_bwd``
run in interpret mode on the CPU, dq, dk and dv, over the backward cases of
tests/test_flash_attention.py, at that file's fp32 tolerance (5e-4; its
softcap+window+GQA+scale case uses 7e-4). Both sides get the same residuals:
the Pallas forward's out and lse. ``FlashAttentionFunction`` on CPU tensors
is held to ``jax.grad`` of ``pallas_flash_attention`` and to torch autograd
through the einsum path, and to ``torch.autograd.gradcheck`` in float64.
Inputs come from a numpy seed and go to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops.flash_pallas import _flash_bwd, _flash_fwd, pallas_flash_attention
from accelerate_tpu_torch.ops.attention import _einsum_attention, flash_attention
from accelerate_tpu_torch.ops.flash_cuda import (
    FlashAttentionFunction,
    flash_bwd,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
)

TOL = dict(atol=5e-4, rtol=5e-4)  # tests/test_flash_attention.py's backward tolerance


def make_qkv(B=1, S=128, H=2, G=None, D=32, seed=0):
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, G, D), dtype=np.float32)
    v = rng.standard_normal((B, S, G, D), dtype=np.float32)
    d_out = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, d_out


def packed_segments(B, S, seed=0):
    """Per-row segment ids 1,1,...,2,2,...,3 with boundaries from the seed."""
    rng = np.random.default_rng(seed)
    segs = np.zeros((B, S), np.int32)
    for b in range(B):
        lo, hi = np.sort(rng.choice(np.arange(8, S - 8), size=2, replace=False))
        segs[b, :lo], segs[b, lo:hi], segs[b, hi:] = 1, 2, 3
    return segs


# (id, shape kwargs, causal, window, segments, softcap, sm_scale, tolerance):
# every backward case of tests/test_flash_attention.py, Pallas blocks 64 x 64
# unless the shape names its own ("block": Pallas takes S a multiple of it).
CASES = [
    ("causal", dict(), True, None, False, None, None, TOL),
    ("non-causal", dict(), False, None, False, None, None, TOL),
    ("window-40", dict(S=256), True, 40, False, None, None, TOL),
    ("segments", dict(S=256, seed=5), True, None, True, None, None, TOL),
    ("segments-window-70", dict(S=256, seed=6), True, 70, True, None, None, TOL),
    ("gqa", dict(H=4, G=2, seed=7), True, None, False, None, None, TOL),
    ("softcap", dict(seed=8), True, None, False, 7.0, None, TOL),
    ("softcap-window-gqa-scale", dict(S=256, H=4, G=2, seed=9), True, 70, False, 5.0, 0.17,
     dict(atol=7e-4, rtol=7e-4)),
    # The families' head_dims of the wgmma dK/dV kernel (Phi-2, GPT-NeoX,
    # GPT-J and Gemma2 with its softcap and scale).
    ("head-dim-80", dict(D=80, seed=12), True, None, False, None, None, TOL),
    ("head-dim-96-window", dict(S=256, D=96, seed=13), True, 70, False, None, None, TOL),
    ("head-dim-256-softcap-gqa-scale", dict(H=4, G=2, D=256, seed=14), True, None, False, 50.0,
     256.0 ** -0.5, TOL),
    # The edges of the wgmma dQ kernel's tiles at the same head_dims: a
    # ragged end, non-causal GQA with segments, a window across segments.
    ("head-dim-96-ragged-200", dict(S=200, D=96, seed=15, block=40), True, None, False, None,
     None, TOL),
    ("head-dim-80-non-causal-gqa-segments", dict(S=256, H=4, G=2, D=80, seed=16), False, None,
     True, None, None, TOL),
    ("head-dim-256-window-70-segments", dict(S=256, D=256, seed=17), True, 70, True, None, None,
     TOL),
]


def _pallas_grads(q, k, v, d_out, causal, window, segs, softcap, sm_scale, block=64):
    """``_flash_bwd`` on the Pallas forward's residuals, in ``block`` x
    ``block`` tiles; returns the residuals (out [B, S, H, D], lse [B, H, S])
    and (dq, dk, dv) in the models' layout."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    jq, jk, jv, jdo = (jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k, v, d_out))
    jseg = None if segs is None else jnp.asarray(segs)
    out, lse = _flash_fwd(jq, jk, jv, scale, causal, window, block, block, segment_ids=jseg,
                          softcap=softcap)
    grads = _flash_bwd(scale, causal, window, block, block, softcap, (jq, jk, jv, out, lse), jdo,
                       segment_ids=jseg)
    residuals = (np.swapaxes(np.array(out), 1, 2), np.array(lse)[..., 0])
    return residuals, [np.swapaxes(np.asarray(g), 1, 2) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_pallas_backward(case):
    _, shape, causal, window, segments, softcap, sm_scale, tol = case
    shape = dict(shape)
    block = shape.pop("block", 64)
    q, k, v, d_out = make_qkv(**shape)
    segs = packed_segments(q.shape[0], q.shape[1], seed=shape.get("seed", 0)) if segments else None
    (out, lse), expected = _pallas_grads(q, k, v, d_out, causal, window, segs, softcap, sm_scale,
                                         block)
    got = flash_bwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v, out, lse, d_out)), causal=causal,
        sm_scale=sm_scale, sliding_window=window,
        segment_ids=None if segs is None else torch.from_numpy(segs), logit_softcap=softcap)
    for name, a, b in zip(("dq", "dk", "dv"), got, expected):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"{name} mismatch", **tol)


def test_cpu_flash_bwd_takes_the_plain_version_and_counts_no_launch():
    q, k, v, d_out = (torch.from_numpy(t) for t in make_qkv(H=4, G=2))
    out, lse = flash_fwd(q, k, v)
    before = (flash_bwd.dkdv_launches, flash_bwd.dq_launches)
    grads = flash_bwd(q, k, v, out, lse, d_out)
    assert (flash_bwd.dkdv_launches, flash_bwd.dq_launches) == before
    for a, b in zip(grads, flash_bwd_reference(q, k, v, out, lse, d_out)):
        assert torch.equal(a, b)
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape), tuple(k.shape), tuple(v.shape)]


def test_flash_bwd_checks_the_residuals():
    q, k, v, d_out = (torch.from_numpy(t) for t in make_qkv())
    out, lse = flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        flash_bwd(q, k, v, out, lse[:, :1], d_out)
    with pytest.raises(ValueError, match="q's shape"):
        flash_bwd(q, k, v, out[:, :64], lse, d_out)


AUTOGRAD_CASES = [c for c in CASES if c[0] in (
    "causal", "non-causal", "segments-window-70", "softcap-window-gqa-scale")]


@pytest.mark.parametrize("case", AUTOGRAD_CASES, ids=[c[0] for c in AUTOGRAD_CASES])
def test_autograd_function_matches_jax_grad_and_einsum_autograd(case):
    """Grads of sum(out * d_out) through FlashAttentionFunction on CPU
    tensors (plain forward and backward) against jax.grad of the Pallas
    public entry, and against torch autograd through the einsum path."""
    _, shape, causal, window, segments, softcap, sm_scale, tol = case
    q, k, v, d_out = make_qkv(**shape)
    segs = packed_segments(q.shape[0], q.shape[1], seed=shape.get("seed", 0)) if segments else None
    jseg = None if segs is None else jnp.asarray(segs)

    def jax_loss(q, k, v):
        out = pallas_flash_attention(q, k, v, causal=causal, block_q=64, block_k=64,
                                     sm_scale=sm_scale, sliding_window=window, segment_ids=jseg,
                                     logit_softcap=softcap)
        return (out * jnp.asarray(d_out)).sum()

    expected = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))

    tseg = None if segs is None else torch.from_numpy(segs)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFunction.apply(*leaves, tseg, causal, sm_scale, window, softcap)
    (out * torch.from_numpy(d_out)).sum().backward()
    einsum_leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    einsum_out = _einsum_attention(*einsum_leaves, causal, segment_ids=tseg,
                                   sliding_window=window, sm_scale=sm_scale,
                                   logit_softcap=softcap)
    (einsum_out * torch.from_numpy(d_out)).sum().backward()
    for name, leaf, ein, ref in zip("qkv", leaves, einsum_leaves, expected):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), err_msg=f"d{name} vs jax",
                                   **tol)
        np.testing.assert_allclose(leaf.grad.numpy(), ein.grad.numpy(),
                                   err_msg=f"d{name} vs einsum autograd", **tol)


def test_gradcheck_float64():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 24, 4, 16))).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 24, 2, 16))).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((1, 24, 2, 16))).requires_grad_()
    seg = torch.from_numpy(np.repeat([[1] * 10 + [2] * 14], 1, axis=0).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFunction.apply(q, k, v, seg, True, 0.3, 9, 4.0),
        (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFunction.apply(q, k, v, None, False, None, None, None),
        (q, k, v))


def test_flash_attention_is_differentiable_on_cpu_tensors():
    """On the CPU the dispatch takes the einsum path, which autograd
    differentiates; on the card it takes FlashAttentionFunction. Both give
    the plain backward's grads."""
    q, k, v, d_out = (torch.from_numpy(t) for t in make_qkv(H=4, G=2, seed=12))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, sliding_window=40)
    (out * d_out).sum().backward()
    ref_out, lse = flash_fwd_reference(q, k, v, causal=True, sliding_window=40)
    expected = flash_bwd_reference(q, k, v, ref_out, lse, d_out, causal=True, sliding_window=40)
    for leaf, ref in zip(leaves, expected):
        np.testing.assert_allclose(leaf.grad.numpy(), ref.numpy(), **TOL)


def test_kernel_route_of_flash_attention_is_differentiable(monkeypatch):
    """The route flash_attention takes for tensors the kernels tile (on the
    card) goes through FlashAttentionFunction, so q, k and v get gradients.
    Here the gate is opened for CPU tensors, where the route runs the plain
    forward and backward."""
    from accelerate_tpu_torch.ops import attention

    monkeypatch.setattr(attention, "flash_attention_available", lambda q: True)
    q, k, v, d_out = (torch.from_numpy(t) for t in make_qkv(H=4, G=2, seed=13))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.flash_attention(*leaves, causal=True, logit_softcap=5.0)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    (out * d_out).sum().backward()
    ref_out, lse = flash_fwd_reference(q, k, v, causal=True, logit_softcap=5.0)
    expected = flash_bwd_reference(q, k, v, ref_out, lse, d_out, causal=True, logit_softcap=5.0)
    for leaf, ref in zip(leaves, expected):
        assert torch.equal(leaf.grad, ref)


def test_inference_mode_forward_saves_no_graph():
    q, k, v, _ = (torch.from_numpy(t) for t in make_qkv())
    with torch.inference_mode():
        out = FlashAttentionFunction.apply(q, k, v, None, True, None, None, None)
    assert out.grad_fn is None
    torch.testing.assert_close(out, flash_fwd_reference(q, k, v)[0], atol=0, rtol=0)


def test_bf16_reference_rounds_like_the_pallas_backward():
    """bf16 inputs, at tests/test_flash_attention.py's bf16 tolerance (3e-2):
    P and dS are rounded to bf16 before their products on both sides."""
    q, k, v, d_out = make_qkv(H=2, D=64, seed=2)
    jq, jk, jv, jdo = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, d_out))
    jq, jk, jv, jdo = (jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv, jdo))
    out, lse = _flash_fwd(jq, jk, jv, 64 ** -0.5, True, None, 64, 64)
    grads = _flash_bwd(64 ** -0.5, True, None, 64, 64, None, (jq, jk, jv, out, lse), jdo)

    def to_torch(t):
        return torch.from_numpy(np.asarray(jnp.swapaxes(t, 1, 2), np.float32)).to(torch.bfloat16)

    got = flash_bwd_reference(to_torch(jq), to_torch(jk), to_torch(jv), to_torch(out),
                              torch.from_numpy(np.asarray(lse)[..., 0]), to_torch(jdo))
    for a, b in zip(got, grads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.swapaxes(np.asarray(b, np.float32), 1, 2),
                                   atol=3e-2, rtol=3e-2)
