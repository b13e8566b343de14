"""Context parallelism (``ops/ring_attention.py``) over gloo worlds on the
CPU, held against the JAX package's ``ring_attention`` and
``ulysses_attention`` on global arrays over a mesh of emulated CPU devices
of the same axis sizes (the list of ``tests/test_ring_attention.py:34-263``).

Each process takes its chunk of the global q, k, v and output gradient
(rows by ``dp``, the sequence by ``cp``, heads by ``tp``); its output and
its three gradients must equal the same chunk of JAX's within 2e-5 (values)
and 5e-4 (gradients), absolute and relative, at f32: causal and not, GQA
K/V unrepeated (and repeated where the heads do not divide), the ring's
sub-chunked ``inner_chunk``, at cp=2 and cp=4, and composed with dp and
with tp; and a sliding window narrower than the sequence, which gathers
the chunks and attends over the whole sequence. Then the tiny stacked Llama trains under ``attention_backend``
"ring" and "ulysses" at cp=2, and "ulysses" at cp=2 x tp=2, and follows
JAX's 6 steps within 1e-5 relative. The trivial axis, the errors and the
"auto" rule run here. Every child runs under a timeout of 120 s in a
session of its own.
"""

import numpy as np
import pytest
import torch
from torch_mesh_common import check_chunks, jax_llama_run, llama_inputs, run_worker

VALUE_TOL, GRAD_TOL = 2e-5, 5e-4
B, S, H, D = 2, 16, 4, 8


def attention_inputs(tmp_path, cases: dict):
    rng = np.random.default_rng(7)
    arrays = {}
    for name, case in cases.items():
        G = case.get("G", H)
        shapes = {"q": (B, S, H, D), "k": (B, S, G, D), "v": (B, S, G, D), "do": (B, S, H, D)}
        for key, shape in shapes.items():
            arrays[f"{name}.{key}"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(tmp_path / "attn_in.npz", **arrays)
    return arrays


def jax_attention(arrays, name, case, axes):
    import math

    import jax
    import jax.numpy as jnp

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.ops.ring_attention import ring_attention, ulysses_attention

    n = math.prod(axes.values())
    mesh = MeshConfig(**axes, devices=jax.devices()[:n]).build()
    q, k, v, do = (jnp.asarray(arrays[f"{name}.{key}"]) for key in ("q", "k", "v", "do"))
    if case["fn"] == "ring":
        def fn(q, k, v):
            return ring_attention(q, k, v, mesh=mesh, causal=case["causal"],
                                  inner_chunk=case.get("inner", 1024))
    elif case["fn"] == "window":
        from accelerate_tpu.ops.attention import _einsum_attention

        def fn(q, k, v):
            return _einsum_attention(q, k, v, causal=case["causal"],
                                     sliding_window=case["window"])
    else:
        def fn(q, k, v):
            return ulysses_attention(q, k, v, mesh=mesh, causal=case["causal"])
    # One jitted executable: run eagerly, each shard_map'd op of Ulysses
    # dispatches and compiles on its own (~15 s a case, against ~1 s).
    @jax.jit
    def forward_and_grads(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))

    out, dq, dk, dv = forward_and_grads(q, k, v, do)
    return {"o": np.asarray(out), "dq": np.asarray(dq), "dk": np.asarray(dk),
            "dv": np.asarray(dv)}


def check_ranks(ranks, arrays, cases, axes):
    dp, cp, tp = axes.get("dp", 1), axes.get("cp", 1), axes.get("tp", 1)
    for name, case in cases.items():
        want = jax_attention(arrays, name, case, axes)
        for r, got in enumerate(ranks):
            # Row-major coordinates over (dp, cp, tp), tp innermost.
            t, c, d = r % tp, (r // tp) % cp, r // (tp * cp)
            for key, whole in want.items():
                b, s, h = whole.shape[0] // dp, whole.shape[1] // cp, whole.shape[2] // tp
                chunk = whole[d * b:(d + 1) * b, c * s:(c + 1) * s, t * h:(t + 1) * h]
                tol = VALUE_TOL if key == "o" else GRAD_TOL
                np.testing.assert_allclose(got[f"{name}.{key}"], chunk, atol=tol, rtol=tol,
                                           err_msg=f"{name} {key} rank {r}")


WORLDS = {
    "cp2": (2, {"cp": 2}, {
        "ring_causal": {"fn": "ring", "causal": True},
        "ring_full": {"fn": "ring", "causal": False},
        "ring_gqa_sub_chunked": {"fn": "ring", "causal": True, "G": 2, "inner": 4},
        "ulysses_causal": {"fn": "ulysses", "causal": True},
        "ulysses_gqa_full": {"fn": "ulysses", "causal": False, "G": 2},
        "window_whole_sequence": {"fn": "window", "causal": True, "G": 2, "window": 5},
    }),
    "cp4": (4, {"cp": 4}, {
        "ring_gqa_causal": {"fn": "ring", "causal": True, "G": 2, "inner": 2},
        "ring_full": {"fn": "ring", "causal": False},
        "ulysses_causal": {"fn": "ulysses", "causal": True},
        "ulysses_gqa_expanded": {"fn": "ulysses", "causal": True, "G": 2},
    }),
    "dp2xcp2": (4, {"dp": 2, "cp": 2}, {
        "ring_gqa_causal": {"fn": "ring", "causal": True, "G": 2},
        "ulysses_causal": {"fn": "ulysses", "causal": True},
    }),
    "cp2xtp2": (4, {"cp": 2, "tp": 2}, {
        "ring_gqa_causal": {"fn": "ring", "causal": True, "G": 2, "inner": 4},
        "ulysses_gqa_causal": {"fn": "ulysses", "causal": True, "G": 2},
    }),
}


@pytest.mark.parametrize("world", list(WORLDS))
def test_cp_attention_and_grads_follow_the_jax_mesh(tmp_path, world):
    n, axes, cases = WORLDS[world]
    arrays = attention_inputs(tmp_path, cases)
    flags = [f"--{ax}={size}" for ax, size in axes.items()]
    ranks = run_worker(tmp_path, "attn", n, flags, cases)
    check_ranks(ranks, arrays, cases, axes)


@pytest.mark.parametrize("backend", ["ring", "ulysses", "ulysses_tp2"])
def test_cp_llama_follows_the_jax_mesh(tmp_path, backend):
    params, ids, labels = llama_inputs(tmp_path)
    tp = 2 if backend.endswith("_tp2") else 1
    backend = backend.split("_")[0]
    cfg = {"cp": 2, "tp": tp, "backend": backend, "inner": 4}
    ranks = run_worker(tmp_path, "llama", 2 * tp, ["--cp", "2", "--tp", str(tp)], cfg)
    history, model, opt = jax_llama_run(params, ids, labels, {"dp": 1, "cp": 2, "tp": tp},
                                        cp=2, tp=tp, backend=backend, inner=4)
    for got in ranks:
        np.testing.assert_allclose(got["history"], history, rtol=1e-5)
    check_chunks(ranks, model, opt)


class _Mesh:
    """A mesh seen from one process, for the checks that stop before any
    collective."""

    def __init__(self, **sizes):
        self.shape = {ax: sizes.get(ax, 1) for ax in ("pp", "dp", "fsdp", "ep", "cp", "tp")}


def test_trivial_axis_is_flash_attention():
    from accelerate_tpu_torch.ops.attention import flash_attention
    from accelerate_tpu_torch.ops.ring_attention import (
        context_parallel_attention,
        ring_attention,
        ulysses_attention,
    )

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=g)
    k, v = torch.randn(2, 16, 2, 8, generator=g), torch.randn(2, 16, 2, 8, generator=g)
    want = flash_attention(q, k, v, causal=True)
    for fn in (ring_attention, ulysses_attention, context_parallel_attention):
        torch.testing.assert_close(fn(q, k, v, mesh=_Mesh()), want, rtol=0, atol=0)
    torch.testing.assert_close(ring_attention(q, k, v), want, rtol=0, atol=0)  # no mesh


def test_errors_and_the_auto_rule(monkeypatch):
    import importlib

    # The module: ``accelerate_tpu_torch.ops`` binds the function of the same
    # name, as the JAX package's ``ops`` does.
    ra = importlib.import_module("accelerate_tpu_torch.ops.ring_attention")

    q = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        ra.ring_attention(q, torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8), mesh=_Mesh(cp=2))
    with pytest.raises(ValueError, match="divisible by cp=4"):
        ra.ulysses_attention(q, torch.zeros(1, 4, 6, 8), torch.zeros(1, 4, 6, 8),
                             mesh=_Mesh(cp=4))
    with pytest.raises(ValueError, match="unknown context-parallel strategy"):
        ra.context_parallel_attention(q, q, q, mesh=_Mesh(cp=2), strategy="bogus")
    picked = []
    monkeypatch.setattr(ra, "ring_attention", lambda *a, **k: picked.append("ring"))
    monkeypatch.setattr(ra, "ulysses_attention", lambda *a, **k: picked.append("ulysses"))
    ra.context_parallel_attention(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 2, 8),
                                  torch.zeros(1, 4, 2, 8), mesh=_Mesh(cp=2))
    ra.context_parallel_attention(torch.zeros(1, 4, 6, 8), torch.zeros(1, 4, 6, 8),
                                  torch.zeros(1, 4, 6, 8), mesh=_Mesh(cp=4))
    assert picked == ["ulysses", "ring"]


def test_inner_chunk_reads_the_context_parallel_plugin():
    from accelerate_tpu_torch import ContextParallelPlugin
    from accelerate_tpu_torch.ops.ring_attention import _ambient_inner_chunk
    from accelerate_tpu_torch.state import AcceleratorState

    assert _ambient_inner_chunk() == 1024
    AcceleratorState(cpu=True, cp_plugin=ContextParallelPlugin(ring_inner_chunk=64))
    assert _ambient_inner_chunk() == 64
    with pytest.raises(ValueError, match="ring_inner_chunk"):
        ContextParallelPlugin(ring_inner_chunk=0)


def test_uneven_sequence_raises_in_the_loss():
    from accelerate_tpu_torch.models.llama import _loss_inputs
    from accelerate_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"cp": 4}, list(range(4)), rank=0)
    with mesh:
        with pytest.raises(ValueError, match="not divisible by cp=4"):
            _loss_inputs({"input_ids": torch.zeros(2, 6, dtype=torch.long)})
