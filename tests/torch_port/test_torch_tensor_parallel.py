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
