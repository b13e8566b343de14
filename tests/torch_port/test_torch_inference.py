"""Pipelined inference (``inference.py``) against the JAX package's
``PipelinedInferencer`` and ``prepare_pipeline`` (the list of
``tests/test_local_sgd_inference.py:129-240``).

* Parity and padding: the tiny stacked Llama, the same weights on both
  sides, a batch of 6 that 4 microbatches do not divide: logits within
  2e-5 (absolute and relative, f32) of JAX's, here (a ``pp`` axis of one)
  and over a gloo world at pp=2 (a batch of 3 padded to 4, M=2), each
  stage returning the whole batch's logits.
* The microbatch count resolves from the model, then the pipeline plugin,
  then the ``pp`` axis; keyword batch tensors are padded and cut with the
  positional ones; only leaves with the batch dim are cut; the padding
  helper repeats the last row.

The world runs under a timeout of 120 s in a session of its own.
"""

import numpy as np
import pytest
import torch
from torch_mesh_common import llama_inputs, run_worker


def jax_logits(params, ids, M):
    import jax.numpy as jnp

    from accelerate_tpu.inference import prepare_pipeline as jax_prepare
    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined

    module = JaxPipelined(JaxLlamaConfig.tiny(use_flash_attention=False), num_microbatches=M)
    return np.asarray(jax_prepare(module, params=params)(jnp.asarray(ids)))


def port_model(tmp_path, M=None):
    from accelerate_tpu_torch import LlamaConfig, PipelinedLlamaForCausalLM

    inputs = np.load(tmp_path / "llama_in.npz")
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu", num_microbatches=M)
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    return model


def test_padding_and_parity_with_the_jax_inferencer(tmp_path):
    from accelerate_tpu_torch import prepare_pipeline

    params, ids, _ = llama_inputs(tmp_path)
    batch = ids[0, :6]
    fwd = prepare_pipeline(port_model(tmp_path, M=4))
    assert fwd.num_microbatches == 4
    out = fwd(torch.from_numpy(batch).long())
    assert out.shape == (6, 16, 256)
    np.testing.assert_allclose(out.numpy(), jax_logits(params, batch, 4), atol=2e-5, rtol=2e-5)


def test_wraps_a_prepared_model_under_its_policy(tmp_path):
    from accelerate_tpu_torch import Accelerator, prepare_pipeline

    params, ids, _ = llama_inputs(tmp_path)
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    model = acc.prepare(port_model(tmp_path, M=2))
    fwd = prepare_pipeline(model, accelerator=acc)
    out = fwd(torch.from_numpy(ids[0, :3]).long())
    assert out.shape == (3, 16, 256) and out.dtype == torch.float32
    want = jax_logits(params, ids[0, :3], 2)
    rel = np.linalg.norm(out.numpy() - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel  # bf16 compute


def test_pipelined_inference_over_two_stages_follows_jax(tmp_path):
    params, ids, _ = llama_inputs(tmp_path)
    ranks = run_worker(tmp_path, "pipeline", 2, ["--pp", "2"], {})
    want = jax_logits(params, ids[0, :3], 2)
    for got in ranks:
        assert int(got["infer.microbatches"]) == 2
        np.testing.assert_allclose(got["infer.logits"], want, atol=2e-5, rtol=2e-5)


def test_microbatch_count_resolves_like_the_jax_package(tmp_path):
    from accelerate_tpu_torch import PipelineParallelPlugin, prepare_pipeline
    from accelerate_tpu_torch.parallel.mesh import Mesh
    from accelerate_tpu_torch.state import AcceleratorState

    llama_inputs(tmp_path)
    model = port_model(tmp_path)
    assert prepare_pipeline(model).num_microbatches == 1

    class Acc:
        policy = None
        mesh = Mesh({"pp": 4}, list(range(4)))
        state = AcceleratorState(cpu=True, pp_plugin=PipelineParallelPlugin(num_microbatches=3))

    assert prepare_pipeline(model, accelerator=Acc).num_microbatches == 3
    Acc.state.pp_plugin.num_microbatches = 1
    assert prepare_pipeline(model, accelerator=Acc).num_microbatches == 4
    with pytest.raises(ValueError, match="needs params"):
        prepare_pipeline(lambda p, x: x)


def test_kwargs_are_padded_with_the_args_and_cut_back():
    from accelerate_tpu_torch.inference import PipelinedInferencer

    calls = {}

    def apply_fn(params, ids, attention_mask=None):
        calls["shapes"] = (tuple(ids.shape), tuple(attention_mask.shape))
        return {"logits": ids * attention_mask, "aux": torch.arange(16.0)}

    fwd = PipelinedInferencer(apply_fn, params={}, num_microbatches=4)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 9, size=(6, 5)))
    mask = torch.from_numpy((rng.random((6, 5)) > 0.3).astype(np.int64))
    out = fwd(ids, attention_mask=mask)
    assert calls["shapes"] == ((8, 5), (8, 5))
    assert out["logits"].shape == (6, 5) and out["aux"].shape == (16,)
    torch.testing.assert_close(out["logits"], ids * mask)


def test_pad_batch_helper_matches_the_jax_one():
    import jax.numpy as jnp

    from accelerate_tpu.inference import pad_batch_to_multiple as jax_pad
    from accelerate_tpu_torch.inference import pad_batch_to_multiple

    args = (np.arange(10).reshape(5, 2), np.arange(5))
    ours, orig = pad_batch_to_multiple(tuple(torch.from_numpy(a) for a in args), 4)
    theirs, jorig = jax_pad(tuple(jnp.asarray(a) for a in args), 4)
    assert orig == jorig == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    same, orig2 = pad_batch_to_multiple(tuple(torch.from_numpy(a) for a in args), 5)
    assert orig2 == 5 and same[0].shape == (5, 2)
    assert pad_batch_to_multiple({"n": 3}, 4) == ({"n": 3}, None)
