"""The port's flash-attention forward against the JAX package's.

``flash_fwd_reference`` (the plain version the Hopper kernel is held to on
the card) is compared with the Pallas kernel ``_flash_fwd`` run in interpret
mode on the CPU, out and lse, over the forward cases of
tests/test_flash_attention.py, at that file's fp32 tolerance (2e-5). The
port's ``flash_attention`` on a CPU tensor is compared with the JAX einsum
path. Inputs come from a numpy seed and go to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops.attention import _einsum_attention as jax_einsum_attention
from accelerate_tpu.ops.flash_pallas import _flash_fwd, pallas_flash_attention
from accelerate_tpu_torch.ops.attention import _einsum_attention, flash_attention
from accelerate_tpu_torch.ops.flash_cuda import flash_fwd, flash_fwd_reference

TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_flash_attention.py's forward tolerance


def make_qkv(B=2, S=256, H=2, G=None, D=64, seed=0):
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, G, D), dtype=np.float32)
    v = rng.standard_normal((B, S, G, D), dtype=np.float32)
    return q, k, v


def packed_segments(B, S, seed=0):
    """Per-row segment ids 1,1,...,2,2,...,3 with boundaries from the seed."""
    rng = np.random.default_rng(seed)
    segs = np.zeros((B, S), np.int32)
    for b in range(B):
        lo, hi = np.sort(rng.choice(np.arange(8, S - 8), size=2, replace=False))
        segs[b, :lo], segs[b, lo:hi], segs[b, hi:] = 1, 2, 3
    return segs


# (id, shape kwargs, causal, window, segments, softcap, sm_scale, block_q, block_k):
# every forward case of tests/test_flash_attention.py.
CASES = [
    ("causal", dict(), True, None, False, None, None, 128, 128),
    ("non-causal", dict(), False, None, False, None, None, 128, 128),
    ("rectangular-blocks", dict(), True, None, False, None, None, 64, 128),
    *[(f"window-{w}", dict(B=1, D=32), True, w, False, None, None, 64, 64)
      for w in (1, 40, 64, 100)],
    *[(f"banded-{bq}x{bk}-w{w}", dict(B=1, S=512, H=1, D=32, seed=3), True, w, False, None,
       None, bq, bk) for bq, bk, w in ((64, 128, 96), (128, 64, 200), (64, 64, 255))],
    ("segments-causal", dict(D=32, seed=5), True, None, True, None, None, 64, 64),
    ("segments-non-causal", dict(D=32, seed=5), False, None, True, None, None, 64, 64),
    ("segments-rectangular", dict(B=1, H=1, D=32, seed=7), True, None, True, None, None, 64, 128),
    ("segments-window-70", dict(B=1, D=32), True, 70, True, None, None, 64, 64),
    ("gqa-causal", dict(B=1, S=128, H=4, G=2, D=32, seed=7), True, None, False, None, None, 64, 64),
    ("gqa-non-causal", dict(B=1, S=128, H=4, G=2, D=32, seed=7), False, None, False, None, None,
     64, 64),
    ("gqa-window-70", dict(B=1, S=256, H=4, G=2, D=32, seed=7), True, 70, False, None, None,
     64, 64),
    ("gqa-segments", dict(B=1, S=128, H=4, G=2, D=32, seed=7), True, None, True, None, None,
     64, 64),
    ("softcap-causal", dict(B=1, S=128, D=32), True, None, False, 7.0, None, 64, 64),
    ("softcap-non-causal", dict(B=1, S=128, D=32), False, None, False, 7.0, None, 64, 64),
    ("softcap-window-gqa-scale", dict(B=1, S=256, H=4, G=2, D=32, seed=7), True, 70, False, 5.0,
     0.17, 64, 64),
    # The head_dims of the families that the wgmma kernels take since they
    # tile 80 and 96 as a 64-column panel and a tail, and 256 in 64-key
    # tiles (Phi-2, GPT-NeoX, GPT-J, Gemma2's softcap and scale).
    ("head-dim-80", dict(B=1, S=128, H=2, D=80, seed=12), True, None, False, None, None, 64, 64),
    ("head-dim-96-window-segments", dict(B=1, S=256, H=2, D=96, seed=13), True, 70, True, None,
     None, 64, 64),
    ("head-dim-256-softcap-gqa-scale", dict(B=1, S=128, H=4, G=2, D=256, seed=14), True, None,
     False, 50.0, 256.0 ** -0.5, 64, 64),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_pallas_forward(case):
    _, shape, causal, window, segments, softcap, sm_scale, bq, bk = case
    q, k, v = make_qkv(**shape)
    segs = packed_segments(q.shape[0], q.shape[1], seed=shape.get("seed", 0)) if segments else None
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale

    jout, jlse = _flash_fwd(*(jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k, v)), scale,
                            causal, window, bq, bk,
                            segment_ids=None if segs is None else jnp.asarray(segs),
                            softcap=softcap)
    out, lse = flash_fwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=causal, sm_scale=sm_scale,
        sliding_window=window, segment_ids=None if segs is None else torch.from_numpy(segs),
        logit_softcap=softcap)

    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(jout), 1, 2), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)


PUBLIC_CASES = [c for c in CASES if c[0] in (
    "causal", "banded-128x64-w200", "segments-window-70", "softcap-window-gqa-scale")]


@pytest.mark.parametrize("case", PUBLIC_CASES, ids=[c[0] for c in PUBLIC_CASES])
def test_cpu_flash_fwd_matches_pallas_public_entry(case):
    """The wrapper on a CPU tensor (its plain version) against the JAX public entry."""
    _, shape, causal, window, segments, softcap, sm_scale, bq, bk = case
    q, k, v = make_qkv(**shape)
    segs = packed_segments(q.shape[0], q.shape[1], seed=shape.get("seed", 0)) if segments else None
    ref = pallas_flash_attention(
        *(jnp.asarray(t) for t in (q, k, v)), causal=causal, block_q=bq, block_k=bk,
        sm_scale=sm_scale, sliding_window=window,
        segment_ids=None if segs is None else jnp.asarray(segs), logit_softcap=softcap)
    out, _ = flash_fwd(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
                       sm_scale=sm_scale, sliding_window=window,
                       segment_ids=None if segs is None else torch.from_numpy(segs),
                       logit_softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False), dict(causal=True, sliding_window=40),
    dict(causal=True, segments=True), dict(causal=False, logit_softcap=7.0, sm_scale=0.2),
], ids=["causal", "non-causal", "window", "segments", "softcap-scale"])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_flash_attention_cpu_matches_jax_einsum(kwargs, heads):
    """On a CPU tensor the port's dispatch takes its einsum path; both that
    and the plain flash version match JAX's einsum path."""
    kwargs = dict(kwargs)
    H, G = heads
    q, k, v = make_qkv(B=2, S=128, H=H, G=G, D=32, seed=11)
    segs = packed_segments(2, 128, seed=11) if kwargs.pop("segments", False) else None
    ref = jax_einsum_attention(*(jnp.asarray(t) for t in (q, k, v)),
                               segment_ids=None if segs is None else jnp.asarray(segs), **kwargs)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tsegs = None if segs is None else torch.from_numpy(segs)
    out = flash_attention(tq, tk, tv, segment_ids=tsegs, **kwargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    einsum = _einsum_attention(tq, tk, tv, segment_ids=tsegs, **kwargs)
    np.testing.assert_allclose(einsum.numpy(), np.asarray(ref), **TOL)
    plain, _ = flash_fwd_reference(tq, tk, tv, segment_ids=tsegs, **kwargs)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


def test_sliding_window_requires_causal():
    q, k, v = (torch.from_numpy(t) for t in make_qkv(B=1, S=128, H=1, D=32))
    with pytest.raises(ValueError, match="sliding_window requires causal"):
        flash_fwd(q, k, v, causal=False, sliding_window=16)
    with pytest.raises(ValueError, match="sliding_window requires causal"):
        flash_attention(q, k, v, causal=False, sliding_window=16)


def test_rejects_indivisible_heads():
    q, k, v = (torch.from_numpy(t) for t in make_qkv(B=1, S=128, H=4, G=3, D=32))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_fwd(q, k, v, causal=True)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(t) for t in make_qkv(B=1, S=128, H=2, D=32))
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v)
    ref, ref_lse = flash_fwd_reference(q, k, v)
    assert flash_fwd.launches == before
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert lse.shape == (1, 2, 128) and lse.dtype == torch.float32


def test_bf16_reference_matches_pallas_forward():
    """bf16 inputs, at tests/test_flash_attention.py's bf16 tolerance (3e-2)."""
    q, k, v = make_qkv(B=1, S=256, H=2, D=64, seed=2)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    jout, jlse = _flash_fwd(*(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), 64 ** -0.5,
                            True, None, 128, 128)
    tq, tk, tv = (torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)
                  for t in (jq, jk, jv))
    out, lse = flash_fwd_reference(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.swapaxes(np.asarray(jout, np.float32), 1, 2),
                               atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=3e-2, rtol=3e-2)
