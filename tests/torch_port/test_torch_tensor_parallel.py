"""Tensor parallelism over gloo worlds on the CPU, held against the JAX
package on a mesh of emulated CPU devices of the same axis sizes
(``parallel/sharding.py``'s rules, ``models/llama.py``'s column and row
projections).

* Policy: the port's specs for the tiny stacked Llama at tp=2 and at
  fsdp=2 x tp=2 equal JAX's ``infer_param_shardings`` string for string,
  the embedding table split on its hidden dim and ``lm_head`` on the
  vocabulary included (the JAX rules' "shard vocab" comment notwithstanding).
* Training: 6 fused AdamW steps with ``max_grad_norm`` and uneven -100
  label masks at tp=2 (2 processes) and at fsdp=2 x tp=2 with ZeRO and
  activation checkpointing (4 processes): losses and grad norms within
  1e-5 relative of JAX's, and each rank's Adam-moment chunks within 1e-5
  and parameter chunks within 5e-5 (of the largest entry) of the elements
  JAX's device r holds (``torch_mesh_common.check_chunks`` says why the
  two tolerances). Every child runs under a timeout of 120 s in a session
  of its own.
* T5 at tp=2: 4 steps' losses and grad norms within 1e-5 relative of the
  JAX run on 2 emulated devices, the projections split as the JAX rules
  split them.
"""

import json

import numpy as np
import pytest
from torch_mesh_common import (
    check_chunks,
    jax_llama_run,
    llama_inputs,
    run_worker,
)


def jax_param_specs(axes: dict, fsdp: bool):
    import math

    import jax

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
    from accelerate_tpu.parallel.sharding import _leaf_path_str
    from accelerate_tpu.parallel.sharding import infer_param_shardings as jax_params
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP
    from accelerate_tpu.utils import TensorParallelPlugin as JaxTP

    params = JaxPipelined(JaxLlamaConfig.tiny()).init_params(jax.random.PRNGKey(0))
    n = math.prod(axes.values())
    mesh = MeshConfig(**axes, devices=jax.devices()[:n]).build()
    sh = jax_params(params, mesh, fsdp_plugin=JaxFSDP(min_weight_size_to_shard=1024)
                    if fsdp else None, tp_plugin=JaxTP(tp_size=axes["tp"]))
    paths = [(_leaf_path_str(p), tuple(np.shape(x)))
             for p, x in jax.tree_util.tree_leaves_with_path(params)]
    specs = [str(s.spec) for s in jax.tree_util.tree_leaves(sh, is_leaf=lambda x: hasattr(
        x, "spec"))]
    return paths, specs


@pytest.mark.parametrize("axes,fsdp", [({"tp": 2}, False), ({"fsdp": 2, "tp": 2}, True)],
                         ids=["tp2", "fsdp2xtp2"])
def test_specs_equal_the_jax_policy_string_for_string(axes, fsdp):
    from accelerate_tpu_torch import (
        FullyShardedDataParallelPlugin,
        LlamaConfig,
        PipelinedLlamaForCausalLM,
        TensorParallelPlugin,
    )
    from accelerate_tpu_torch.parallel import sharding

    paths, jax_specs = jax_param_specs(axes, fsdp)
    plugin = FullyShardedDataParallelPlugin(min_weight_size_to_shard=1024) if fsdp else None
    tp = TensorParallelPlugin(tp_size=2)
    ours = sharding.infer_param_shardings(paths, axes, fsdp_plugin=plugin, tp_plugin=tp)
    assert [str(s) for s in ours.values()] == jax_specs
    by_path = dict(zip((p for p, _ in paths), jax_specs))
    # The embedding table [vocab, hidden] splits hidden; lm_head's kernel
    # [hidden, vocab] splits the vocabulary.
    assert by_path["model/embed_tokens/embedding"].endswith("'tp')")
    assert by_path["lm_head/kernel"].endswith("'tp')")
    # The layout the accelerator stores by is JAX's in the torch layout.
    module = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    stored = sharding.layout_specs(module, plugin, axes, tp)
    for name, p in module.named_parameters():
        ref = sharding.reference_path(module, name)
        kernel = sharding._is_kernel(module, name, p.ndim)
        assert stored[name] == sharding.swap_spec(ours[ref], p.ndim, kernel), name


CASES = {
    "tp2": (2, ["--tp", "2"], {"tp": 2}, {"tp": 2}),
    "fsdp2xtp2": (4, ["--fsdp", "2", "--tp", "2"],
                  {"tp": 2, "fsdp": "FULL_SHARD", "zero": True, "remat": True},
                  {"fsdp": 2, "tp": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_llama_follows_the_jax_mesh(tmp_path, case):
    n, flags, cfg, axes = CASES[case]
    params, ids, labels = llama_inputs(tmp_path)
    ranks = run_worker(tmp_path, "llama", n, flags, cfg)
    history, model, opt = jax_llama_run(params, ids, labels, {"dp": 1, **axes}, **{
        k: v for k, v in cfg.items() if k in ("fsdp", "zero", "remat", "tp")})
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["history"], history, rtol=1e-5)
        assert str(got["distributed_type"]) == ("FSDP" if "fsdp" in cfg else "TENSOR_PARALLEL")
        coords = json.loads(str(got["coords"]))
        assert coords["tp"] == r % 2 and coords["fsdp"] == (r // 2 if n == 4 else 0)
    check_chunks(ranks, model, opt)


def test_tensor_parallel_t5_follows_the_jax_mesh(tmp_path):
    """The tiny T5 (relu, tied) trains at tp=2 over gloo: 4 fused AdamW
    steps of ``seq2seq_lm_loss`` with clip 1.0, each rank's losses and grad
    norms within 1e-5 relative of the JAX ``Accelerator``'s on 2 emulated
    devices under ``MeshConfig(tp=2)`` (reference ``tests/test_models.py``
    trains it at fsdp 4 x tp 2). The projections split as the JAX rules
    split them: ``query``/``key``/``value`` and ``intermediate`` by column,
    ``attn_out`` and ``mlp_out`` by row."""
    import jax
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import MeshConfig as JaxMeshConfig
    from accelerate_tpu import Model
    from accelerate_tpu.data_loader import make_global_batch
    from accelerate_tpu.models import t5 as jt5
    from accelerate_tpu.state import AcceleratorState
    from accelerate_tpu.utils import TensorParallelPlugin as JaxTP
    from accelerate_tpu_torch import T5Config, state_dict_from_flax

    lr, steps = 1e-3, 4
    cfg = jt5.T5Config.tiny(dropout_rate=0.0)
    module = jt5.T5ForConditionalGeneration(cfg)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(0), src_len=16, tgt_len=8))
    ids = rng.integers(0, cfg.vocab_size, (steps, 4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (steps, 4, 8)).astype(np.int32)
    state = state_dict_from_flax(params, T5Config.tiny())
    np.savez(tmp_path / "t5_in.npz", input_ids=ids, labels=labels,
             **{f"param.{k}": v.numpy() for k, v in state.items()})
    ranks = run_worker(tmp_path, "t5", 2, ["--tp", "2"], {"tp": 2, "lr": lr})

    AcceleratorState._reset_state()
    acc = JaxAccelerator(mesh_config=JaxMeshConfig(tp=2, devices=jax.devices()[:2]),
                         tp_plugin=JaxTP(tp_size=2))
    acc.prepare(Model(module, params), optax.adamw(lr, weight_decay=1e-4))
    step = acc.compile_train_step(jt5.seq2seq_lm_loss(module.apply), max_grad_norm=1.0)
    history = []
    for s in range(steps):
        m = step(make_global_batch({"input_ids": ids[s], "labels": labels[s]}, acc.mesh))
        history.append([float(m["loss"]), float(m["grad_norm"])])
    AcceleratorState._reset_state()
    for got in ranks:
        np.testing.assert_allclose(got["history"], np.asarray(history), rtol=1e-5)
        assert str(got["distributed_type"]) == "TENSOR_PARALLEL"
        specs = json.loads(str(got["specs"]))
        assert specs["encoder_layer.0.attention.query.weight"] == "PartitionSpec('tp',)"
        assert specs["decoder_layer.1.cross_attention.attn_out.weight"] == \
            "PartitionSpec(None, 'tp')"
        assert specs["encoder_layer.1.mlp.intermediate.weight"] == "PartitionSpec('tp',)"
        assert specs["decoder_layer.0.mlp.mlp_out.weight"] == "PartitionSpec(None, 'tp')"
