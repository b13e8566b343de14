"""Pipeline parallelism (``parallel/pipeline.py``) over gloo worlds on the
CPU, held against the JAX package's ``pipeline_apply`` and pipelined Llama
on a ``pp`` mesh of emulated CPU devices (the list of
``tests/test_pipeline.py``).

* ``pipeline_apply`` at pp=2 over 4 stacked layers (each stage holding 2):
  M=2 and M=4 microbatches, with and without remat, and extras riding
  along; the output and the gradients of the input and of this stage's
  layers within 1e-5 of JAX's (absolute and relative, f32). A batch that
  M does not divide raises.
* The tiny stacked Llama at pp=2, M=2, and with M=4 under remat (each
  stage holding one layer): 6 fused AdamW steps' losses and grad norms
  within 1e-5 relative of JAX's, each rank's chunks as in
  ``torch_mesh_common.check_chunks``; the stages' checkpoint after step 3
  merges back into the gathered leaves exactly.
* Here: a ``pp`` axis of one is a plain loop over the layers; the stacked
  and sequential layouts round-trip; layer gaps and disagreeing leaves
  raise.

Every child runs under a timeout of 120 s in a session of its own.
"""

import numpy as np
import pytest
import torch
from torch_mesh_common import check_chunks, jax_llama_run, llama_inputs, run_worker

CASES = {"M2": {"M": 2}, "M4": {"M": 4}, "M2_remat": {"M": 2, "remat": True},
         "M2_extras": {"M": 2, "extras": True}}


def pipe_inputs(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {"w": 0.5 * rng.standard_normal((4, 6, 6)), "b": 0.1 * rng.standard_normal((4, 6)),
              "x": rng.standard_normal((8, 6)), "extras": rng.standard_normal((8, 6)),
              "dy": rng.standard_normal((8, 6))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    np.savez(tmp_path / "pipe_in.npz", **arrays)
    return arrays


def jax_pipeline(arrays, case):
    import jax
    import jax.numpy as jnp

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.parallel.pipeline import pipeline_apply

    mesh = MeshConfig(dp=1, pp=2, devices=jax.devices()[:2]).build()

    def block_fn(p, h, extras):
        h = jnp.tanh(h @ p["w"] + p["b"])
        return h if isinstance(extras, tuple) else h + extras

    def fn(params, x):
        extras = jnp.asarray(arrays["extras"]) if case.get("extras") else None
        return pipeline_apply(block_fn, params, x, extras=extras, mesh=mesh,
                              num_microbatches=case["M"], remat=case.get("remat", False))

    params = {"w": jnp.asarray(arrays["w"]), "b": jnp.asarray(arrays["b"])}
    y, vjp = jax.vjp(jax.jit(fn), params, jnp.asarray(arrays["x"]))
    dp, dx = vjp(jnp.asarray(arrays["dy"]))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dw": np.asarray(dp["w"]),
            "db": np.asarray(dp["b"])}


def test_pipeline_apply_follows_the_jax_schedule(tmp_path):
    arrays = pipe_inputs(tmp_path)
    llama_inputs(tmp_path)
    ranks = run_worker(tmp_path, "pipeline", 2, ["--pp", "2"], CASES)
    for name, case in CASES.items():
        want = jax_pipeline(arrays, case)
        for r, got in enumerate(ranks):
            for key, value in want.items():
                if key in ("dw", "db"):
                    value = value[2 * r:2 * (r + 1)]  # this stage's layers
                np.testing.assert_allclose(got[f"{name}.{key}"], value, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name} {key} rank {r}")
    for got in ranks:
        assert "batch=4 not divisible by num_microbatches=3" in str(got["error.batch"])


@pytest.mark.parametrize("case", ["M2", "M4_remat"])
def test_pipelined_llama_follows_the_jax_mesh(tmp_path, case):
    M, remat = (2, False) if case == "M2" else (4, True)
    params, ids, labels = llama_inputs(tmp_path)
    cfg = {"pp": 2, "M": M, "model_remat": remat, "save_at": 3, "save": "ck"}
    ranks = run_worker(tmp_path, "llama", 2, ["--pp", "2"], cfg)
    # The stages' checkpoint merges back into the gathered stacked leaves.
    from accelerate_tpu_torch.checkpointing import merged_model_tensors

    merged = merged_model_tensors(tmp_path / "ck")
    for name, tensor in merged.items():
        np.testing.assert_array_equal(tensor.numpy(), ranks[0][f"whole.{name}"])
    assert merged["model.blocks.mlp.up_proj.weight"].shape[0] == 2
    history, model, opt = jax_llama_run(params, ids, labels, {"dp": 1, "pp": 2}, pp=2, M=M,
                                        model_remat=remat)
    for got in ranks:
        np.testing.assert_allclose(got["history"], history, rtol=1e-5)
        assert str(got["distributed_type"]) == "PIPELINE_PARALLEL"
    check_chunks(ranks, model, opt)


def test_no_pipeline_axis_is_a_plain_loop():
    from accelerate_tpu_torch.parallel.pipeline import pipeline_apply

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 5, 5, generator=g, requires_grad=True)}
    x = torch.randn(4, 5, generator=g)
    y = pipeline_apply(lambda p, h, e: torch.tanh(h @ p["w"]), params, x, num_microbatches=3)
    h = x
    for i in range(3):
        h = torch.tanh(h @ params["w"][i])
    torch.testing.assert_close(y, h, rtol=0, atol=0)
    y.sum().backward()
    assert params["w"].grad.shape == (3, 5, 5)


def test_stack_and_unstack_round_trip_and_reject_gaps():
    from accelerate_tpu_torch import PipelinedLlamaForCausalLM
    from accelerate_tpu_torch.parallel.pipeline import (
        num_layers_of,
        stack_layer_params,
        unstack_layer_params,
    )

    state = {f"model.layers.{i}.w": torch.full((2,), float(i)) for i in range(3)}
    state["model.norm.scale"] = torch.ones(2)
    stacked, rest = stack_layer_params(state, prefix="model.layers.")
    assert set(rest) == {"model.norm.scale"} and stacked["w"].shape == (3, 2)
    assert num_layers_of(stacked) == 3
    back = unstack_layer_params(stacked, prefix="model.layers.")
    assert all(torch.equal(back[k], state[k]) for k in back)
    converted = PipelinedLlamaForCausalLM.from_sequential_params(state)
    assert torch.equal(converted["model.blocks.w"], stacked["w"])
    gap = {k: v for k, v in state.items() if ".1." not in k}
    with pytest.raises(ValueError, match="non-contiguous"):
        stack_layer_params(gap, prefix="model.layers.")
    with pytest.raises(ValueError, match="no 'layers.N' entries"):
        stack_layer_params({"x": torch.ones(1)})
    with pytest.raises(ValueError, match="disagree on layer dim"):
        num_layers_of({"a": torch.ones(2, 3), "b": torch.ones(3, 3)})
    with pytest.raises(ValueError, match="empty"):
        num_layers_of({})
