"""Expert parallelism over gloo worlds on the CPU against the JAX package
on an emulated mesh of the same shape (``torch_moe_worker.py`` runs in
each process, launched through ``accelerate-tpu-torch launch --ep``).

Every world trains the seeded tiny Mixtral (capacity factor 1, so tokens
drop) for 5 fused AdamW steps on rows whose label masks differ between
the data shards, in two cases, in one launched world a mesh shape:

* ``ep`` 2 (2 processes): one routing group a process (each routes its
  group and the experts' slots cross by all-to-all), and one group for the
  whole batch (every process routes it and runs its block of experts),
  the second under FULL_SHARD with activation checkpointing; the first
  case saves a checkpoint after 3 steps, which ``merge-weights`` gives
  back whole and one process resumes (``via_host``);
* ``dp`` 2 x ``ep`` 2 (4 processes): the same two cases (the first with
  the default groups, one a process), the second's one group spanning
  both data shards;
* ``fsdp`` 2 x ``ep`` 2 (4 processes) under FULL_SHARD: each expert leaf
  split over ``ep`` on dim 0 and over ``fsdp`` on its largest other dim,
  gathered over ``fsdp`` only for the layer;
* ``ep`` 2 x ``tp`` 2 (4 processes): the experts' hidden width split over
  ``tp`` too (``("ep", None, "tp")``, ``("ep", "tp")``), the partial
  outputs summed over ``tp``; the grouped case saves after 3 steps and is
  merged and resumed in one process, and a Qwen2-MoE case (a shared
  expert, column/row over ``tp``, and a dense layer) runs beside it;
* ``cp`` 2 x ``pp`` 2 (4 processes): one routing group over the whole
  batch, spanning the ``cp`` chunks of every row, and the Mixtral whole
  over ``pp``, as in the JAX package.

Losses and grad norms are held within 1e-5 relative of JAX's, and each
rank's parameter and Adam-moment chunks, leaf for leaf, to the elements
the JAX package's device of that rank holds under its declared specs
(``torch_mesh_common.check_chunks``' tolerances). Every child runs under
a timeout of 120 s in a session of its own.
"""

import json
import math

import numpy as np
import pytest
from torch_mesh_common import adam_state, close, launch

STEPS = 5

#: The cases of every world: the tiny Mixtral's config overrides and the
#: plugins. Under ep 2 the grouped case names its 2 groups, so that one
#: process resuming its checkpoint routes the same groups.
GROUPED = {"config": {"num_expert_groups": None, "capacity_factor": 1.0}}
ONE_GROUP = {"config": {"num_expert_groups": 1, "capacity_factor": 1.0},
             "fsdp": "FULL_SHARD", "remat": True}
SAVED = {"config": {"num_expert_groups": 2, "capacity_factor": 1.0}, "save_at": 3, "save": "ck"}
QWEN2_MOE = {"config": {"norm_topk_prob": False, "shared_expert_intermediate_size": 48,
                        "mlp_only_layers": [1], "dense_intermediate_size": 96,
                        "capacity_factor": 1.0},
             "inputs": "qwen2_moe"}
WORLDS = {
    "ep2": ({"ep": 2}, {"grouped": SAVED, "one_group": ONE_GROUP}),
    "dp2xep2": ({"dp": 2, "ep": 2}, {"grouped": GROUPED, "one_group": ONE_GROUP}),
    "fsdp2xep2": ({"fsdp": 2, "ep": 2}, {"grouped": {**GROUPED, "fsdp": "FULL_SHARD"}}),
    "ep2xtp2": ({"ep": 2, "tp": 2}, {"grouped": SAVED, "qwen2_moe": QWEN2_MOE}),
    "cp2xpp2": ({"cp": 2, "pp": 2}, {"grouped": GROUPED}),
}
AXES = ("ep", "tp", "cp", "pp")


def moe_inputs(tmp_path, rows: int = 8, seq: int = 16, variant: str = "moe", config=None):
    """The seeded tiny Mixtral (flax params perturbed by noise; ``config``
    overrides, e.g. Qwen2-MoE's) and ``STEPS`` batches of ``rows x seq``
    ids and labels with uneven -100 masks, written to
    ``<variant>_in.npz`` in the port's layout."""
    import jax

    from accelerate_tpu.models.mixtral import MixtralConfig as JaxConfig
    from accelerate_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
    from accelerate_tpu_torch.models.mixtral import MixtralConfig
    from accelerate_tpu_torch.utils.convert import state_dict_from_flax

    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        JaxMixtral(JaxConfig.tiny_moe(use_flash_attention=False, **(config or {})))
        .init_params(jax.random.PRNGKey(0)))
    ids = rng.integers(0, 256, (STEPS, rows, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2).astype(np.int32)
    labels[:, :, -1] = -100
    labels[:, 0:2, 9:16] = -100  # the first data shard keeps fewer labels
    state = state_dict_from_flax(params, MixtralConfig.tiny_moe(**(config or {})))
    np.savez(tmp_path / f"{variant}_in.npz", input_ids=ids, labels=labels,
             **{f"param.{k}": v.numpy() for k, v in state.items()})
    return params, ids, labels


def jax_moe_run(params, ids, labels, axes: dict, case: dict):
    """The JAX package's fused AdamW steps of the tiny Mixtral on a mesh of
    ``axes`` over emulated CPU devices, with the case's plugins. Returns
    ``(history, model, opt)``."""
    import jax
    import optax

    from accelerate_tpu import Accelerator, MeshConfig, Model
    from accelerate_tpu.data_loader import make_global_batch
    from accelerate_tpu.models.mixtral import MixtralConfig as JaxConfig
    from accelerate_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
    from accelerate_tpu.models.mixtral import mixtral_lm_loss
    from accelerate_tpu.state import AcceleratorState
    from accelerate_tpu.utils import (
        ContextParallelPlugin,
        ExpertParallelPlugin,
        FullyShardedDataParallelPlugin,
        PipelineParallelPlugin,
        TensorParallelPlugin,
    )

    AcceleratorState._reset_state()
    n = math.prod(axes.values())
    plugins = {"ep_plugin": ExpertParallelPlugin(ep_size=axes.get("ep", 1))}
    for axis, plugin in (("tp", TensorParallelPlugin), ("cp", ContextParallelPlugin),
                         ("pp", PipelineParallelPlugin)):
        if axes.get(axis, 1) > 1:
            plugins[f"{axis}_plugin"] = plugin(**{f"{axis}_size": axes[axis]})
    if case.get("fsdp"):
        plugins["fsdp_plugin"] = FullyShardedDataParallelPlugin(
            sharding_strategy=case["fsdp"], activation_checkpointing=case.get("remat", False),
            min_weight_size_to_shard=1024)
    acc = Accelerator(mesh_config=MeshConfig(**axes, devices=jax.devices()[:n]), **plugins)
    cfg = JaxConfig.tiny_moe(use_flash_attention=False, **case["config"])
    module = JaxMixtral(cfg)
    model, opt = acc.prepare(Model(module, params), optax.adamw(1e-4, weight_decay=1e-4))
    step = acc.compile_train_step(mixtral_lm_loss(module.apply, cfg), max_grad_norm=1.0)
    history = []
    for s in range(ids.shape[0]):
        m = step(make_global_batch({"input_ids": ids[s], "labels": labels[s]}, acc.mesh))
        history.append([float(m["loss"]), float(m["grad_norm"])])
    return np.asarray(history), model, opt


def check_moe_chunks(ranks, name, model, opt, config, tol=1e-5, param_tol=5e-5):
    """Each rank's parameter and Adam-moment chunks of case ``name`` against
    the elements the JAX package's device of that rank holds (its whole
    arrays, in the torch layout, cut by the rank's splits), and the splits
    of the expert leaves to the JAX specs: ``ep`` on dim 0, ``tp`` on the
    hidden width (``("ep", None, "tp")``, ``down_proj`` ``("ep", "tp")``)."""
    import jax

    from accelerate_tpu_torch.checkpointing import _mesh_chunk
    from accelerate_tpu_torch.models.mixtral import MixtralConfig
    from accelerate_tpu_torch.utils.convert import state_dict_from_flax

    adam = adam_state(opt.opt_state)
    trees = {kind: state_dict_from_flax(jax.device_get(tree), MixtralConfig.tiny_moe(**config))
             for kind, tree in (("param", model.params), ("mu", adam.mu), ("nu", adam.nu))}
    sizes = dict(model.mesh.shape)
    for r, got in enumerate(ranks):
        coords = json.loads(str(got[f"{name}.coords"]))
        splits = json.loads(str(got[f"{name}.splits"]))
        for kind, tree in trees.items():
            for leaf, whole in tree.items():
                split = splits["param" if kind == "param" else "moment"][leaf]
                if ".experts." in leaf and sizes.get("ep", 1) > 1:
                    assert split.get("ep") == 0, (leaf, split)
                if ".experts." in leaf and sizes.get("tp", 1) > 1:
                    assert split.get("tp") == (1 if leaf.endswith("down_proj") else 2), \
                        (leaf, split)
                want = _mesh_chunk(whole, {ax: int(d) for ax, d in split.items()}, sizes, coords)
                close(got[f"{name}.{kind}.{leaf}"], want.numpy(), f"rank {r} {kind} {leaf}",
                      param_tol if kind == "param" else tol)


def run_world(tmp_path, n: int, flags, cases: dict) -> list:
    launch("--num_processes", str(n), *flags, str(_worker()), "train", str(tmp_path),
           json.dumps(cases))
    return [np.load(tmp_path / f"train_{r}.npz") for r in range(n)]


def _worker():
    from pathlib import Path

    return Path(__file__).resolve().parent / "torch_moe_worker.py"


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_expert_parallel_world_follows_the_jax_mesh(tmp_path, world):
    axes, cases = WORLDS[world]
    inputs = {variant: moe_inputs(tmp_path, variant=variant, config=case["config"])
              for variant, case in [("moe", {"config": {}})]
              + [(c["inputs"], c) for c in cases.values() if "inputs" in c]}
    n = math.prod(axes.values())
    cases = {name: {**case, **{ax: axes.get(ax, 1) for ax in AXES}}
             for name, case in cases.items()}
    flags = [f"--{ax}={size}" for ax, size in axes.items()]
    ranks = run_world(tmp_path, n, flags, cases)
    for name, case in cases.items():
        params, ids, labels = inputs[case.get("inputs", "moe")]
        history, model, opt = jax_moe_run(params, ids, labels, axes, case)
        for got in ranks:
            np.testing.assert_allclose(got[f"{name}.history"], history, rtol=1e-5,
                                       err_msg=name)
        # Capacity drops bite in the last step's routing.
        assert max(got[f"{name}.dropped"].max() for got in ranks) > 0, name
        check_moe_chunks(ranks, name, model, opt, case["config"])
        if case.get("save"):
            check_merged_and_resumed(tmp_path, ranks, name, case)


def check_merged_and_resumed(tmp_path, ranks, name, case):
    """``merge-weights`` of the case's checkpoint gives back its whole
    state dict (the experts stitched along dim 0), and one process resumes
    from it (``via_host``, as ``world.json`` names another world) and
    repeats the last steps' losses and grad norms within 2e-5 relative."""
    from torch_moe_worker import setup

    from accelerate_tpu_torch.checkpointing import load_safetensors
    from accelerate_tpu_torch.commands.merge import merge_command, merge_command_parser

    out = tmp_path / "merged.safetensors"
    assert merge_command(merge_command_parser().parse_args([str(tmp_path / case["save"]),
                                                            str(out)])) == 0
    merged = load_safetensors(out)
    prefix = f"{name}.whole."
    whole = {n[len(prefix):] for n in ranks[0].files if n.startswith(prefix)}
    assert set(merged) == whole
    for leaf, tensor in merged.items():
        np.testing.assert_array_equal(tensor.numpy(), ranks[0][prefix + leaf])
    assert merged["layers.0.mlp.experts.gate_proj"].shape == (4, 64, 128)

    acc, model, opt, step, batch, steps = setup(tmp_path, {**case, **dict.fromkeys(AXES, 1)})
    acc.load_state(str(tmp_path / case["save"]))
    resumed = [[m["loss"].item(), m["grad_norm"].item()]
               for m in (step(batch(s)) for s in range(case["save_at"], steps))]
    np.testing.assert_allclose(resumed, ranks[0][f"{name}.history"][case["save_at"]:],
                               rtol=2e-5)


@pytest.mark.parametrize("variant", ["mixtral", "qwen2_moe"])
def test_expert_and_router_specs_equal_the_jax_policy_on_dp2_ep2_tp2(variant):
    """The port's policy on a dp 2 x ep 2 x tp 2 mesh gives every leaf of
    the tiny Mixtral (and Qwen2-MoE) the JAX package's spec string for
    string (``tests/test_moe.py``'s ``test_expert_sharding_rules``): the
    experts ``ep`` on dim 0 and ``tp`` on their hidden width, the router
    whole, the shared expert column/row; the stored layout is that in the
    torch layout."""
    import jax

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.models.mixtral import MixtralConfig as JaxConfig
    from accelerate_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
    from accelerate_tpu.parallel.sharding import _leaf_path_str
    from accelerate_tpu.parallel.sharding import infer_param_shardings as jax_params
    from accelerate_tpu.utils import ExpertParallelPlugin as JaxEP
    from accelerate_tpu.utils import TensorParallelPlugin as JaxTP
    from accelerate_tpu_torch import ExpertParallelPlugin, TensorParallelPlugin
    from accelerate_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    from accelerate_tpu_torch.parallel import sharding

    config = QWEN2_MOE["config"] if variant == "qwen2_moe" else {}
    params = JaxMixtral(JaxConfig.tiny_moe(use_flash_attention=False, **config)).init_params(
        jax.random.PRNGKey(0))
    axes = {"dp": 2, "ep": 2, "tp": 2}
    mesh = MeshConfig(**axes, devices=jax.devices()[:8]).build()
    sh = jax_params(params, mesh, tp_plugin=JaxTP(tp_size=2),
                    ep_plugin=JaxEP(ep_size=2, num_experts=4))
    paths = [(_leaf_path_str(p), tuple(np.shape(x)))
             for p, x in jax.tree_util.tree_leaves_with_path(params)]
    want = [str(s.spec) for s in jax.tree_util.tree_leaves(sh, is_leaf=lambda x: hasattr(
        x, "spec"))]
    tp, ep = TensorParallelPlugin(tp_size=2), ExpertParallelPlugin(ep_size=2)
    ours = sharding.infer_param_shardings(paths, axes, tp_plugin=tp, ep_plugin=ep)
    assert [str(s) for s in ours.values()] == want
    assert str(ours["layers_0/mlp/experts/gate_proj"]) == "PartitionSpec('ep', None, 'tp')"
    assert str(ours["layers_0/mlp/experts/up_proj"]) == "PartitionSpec('ep', None, 'tp')"
    assert str(ours["layers_0/mlp/experts/down_proj"]) == "PartitionSpec('ep', 'tp')"
    assert str(ours["layers_0/mlp/router"]) == "PartitionSpec()"
    if variant == "qwen2_moe":
        assert str(ours["layers_0/mlp/shared_gate_proj/kernel"]) == "PartitionSpec(None, 'tp')"
        assert str(ours["layers_0/mlp/shared_down_proj/kernel"]) == "PartitionSpec('tp',)"
    module = MixtralForCausalLM(MixtralConfig.tiny_moe(**config), device="cpu")
    stored = sharding.layout_specs(module, None, axes, tp, None, ep)
    for name, p in module.named_parameters():
        ref = sharding.reference_path(module, name)
        kernel = sharding._is_kernel(module, name, p.ndim)
        assert stored[name] == sharding.swap_spec(ours[ref], p.ndim, kernel), name
