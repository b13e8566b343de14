"""Sharded training state in one process: the sharding policy, the FSDP
and DeepSpeed plugins, host offload, and ``merge-weights`` and ``launch
--fsdp`` (``parallel/sharding.py``, ``parallel/host_offload.py``,
``utils/dataclasses.py``, ``commands/merge.py``).

* Policy: the port's ``infer_param_shardings`` and
  ``infer_opt_state_shardings`` on the JAX tiny stacked Llama's leaves
  and AdamW state, and on the shapes of the JAX package's
  ``tests/test_zero_sharding.py:82-160``, give JAX's ``PartitionSpec``s
  string for string, at fsdp 2 and 4, and the same one-line report with
  its four counts; the layout the accelerator stores by (torch's ``[out,
  in]`` weights) is JAX's with a kernel's last two dims swapped.
* The DeepSpeed stage-to-strategy translation and ``_schedule_fn``'s
  learning rates at steps 0-20 equal the JAX plugin's; the ``FSDP_*``
  variables set the same fields.
* Offload (reference ``tests/test_host_offload.py``): the offloaded step's
  trajectory equals the resident one bit for bit and the state reports
  the host memory kind between steps, also on the eager loop path and
  through a ``state_dict`` round trip; DeepSpeed's ``offload_optimizer:
  cpu`` is ``cpu_offload``; the plugin's remat matches the baseline loss.
  At one process every FSDP mode follows the unsharded trajectory bit for
  bit, and a FULL_SHARD step with remat gathers each layer twice.
* A frozen parameter gets no optimizer state under ZeRO (the JAX LoRA
  case); ``merge-weights`` merges a sharded ``save_model`` export (the
  JAX package's ``tests/test_cli.py:404-420``).
"""

import json
import logging

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import (
    Accelerator,
    DeepSpeedPlugin,
    FullyShardedDataParallelPlugin,
    LlamaConfig,
    PipelinedLlamaForCausalLM,
    fused_causal_lm_loss,
)
from accelerate_tpu_torch.parallel import host_offload, sharding


def jax_llama_leaves():
    import jax

    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined

    return JaxPipelined(JaxLlamaConfig.tiny()).init_params(jax.random.PRNGKey(0))


def paths_and_shapes(tree):
    import jax

    from accelerate_tpu.parallel.sharding import _leaf_path_str

    return [(_leaf_path_str(p), tuple(np.shape(x)))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def jax_specs(tree):
    import jax

    return [str(s.spec) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: hasattr(x, "spec"))]


def report(caplog, logger_name):
    return [r.getMessage() for r in caplog.records if r.name == logger_name
            and r.getMessage().startswith("opt-state zero sharding")]


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("strategy", ["FULL_SHARD", "NO_SHARD"])
def test_llama_specs_and_report_equal_the_jax_policy(fsdp, strategy, caplog):
    import jax
    import optax

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.parallel.sharding import infer_opt_state_shardings as jax_opt
    from accelerate_tpu.parallel.sharding import infer_param_shardings as jax_params
    from accelerate_tpu.parallel.sharding import sharding_summary as jax_summary
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP

    params = jax_llama_leaves()
    mesh = MeshConfig(fsdp=fsdp, devices=jax.devices()[:fsdp]).build()
    jplugin, plugin = JaxFSDP(sharding_strategy=strategy), FullyShardedDataParallelPlugin(
        sharding_strategy=strategy)
    jsh = jax_params(params, mesh, fsdp_plugin=jplugin)
    leaves = paths_and_shapes(params)
    ours = sharding.infer_param_shardings(leaves, {"fsdp": fsdp}, fsdp_plugin=plugin)
    assert [str(s) for s in ours.values()] == jax_specs(jsh)
    assert sharding.sharding_summary(ours) == jax_summary(jsh)

    opt_state = optax.adamw(1e-3).init(params)
    caplog.set_level(logging.INFO)
    jopt = jax_opt(opt_state, mesh, params=params, param_shardings=jsh)
    opt_ours = sharding.infer_opt_state_shardings(
        paths_and_shapes(opt_state), {"fsdp": fsdp}, params=leaves,
        param_shardings=list(ours.values()))
    assert [str(s) for s in opt_ours.values()] == jax_specs(jopt)
    jline = report(caplog, "accelerate_tpu.parallel.sharding")
    line = report(caplog, "accelerate_tpu_torch.parallel.sharding")
    assert line == jline and len(line) == 1, (line, jline)


@pytest.mark.parametrize("fsdp", [2, 4])
def test_stored_layout_is_the_jax_policy_in_the_torch_layout(fsdp):
    """The accelerator decides on each leaf's JAX shape: a kernel's chosen
    dimension comes back with the last two dims swapped."""
    import jax

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.parallel.sharding import infer_param_shardings as jax_params
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP
    from accelerate_tpu_torch.utils.convert import _flatten

    params = jax_llama_leaves()
    mesh = MeshConfig(fsdp=fsdp, devices=jax.devices()[:fsdp]).build()
    jsh = jax_params(params, mesh, fsdp_plugin=JaxFSDP())
    flat = dict(_flatten(jsh)) if isinstance(jsh, dict) else None
    module = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ours = sharding.layout_specs(module, FullyShardedDataParallelPlugin(), fsdp)
    for path, spec in flat.items():
        name = ".".join(path[:-1]) + (".weight" if path[-1] in ("kernel", "embedding")
                                      else "." + path[-1])
        axes = list(spec.spec) + [None] * (3 - len(spec.spec))
        ndim = len(module.get_parameter(name).shape)
        axes = axes[:ndim]
        if path[-1] == "kernel":
            axes[-2], axes[-1] = axes[-1], axes[-2]
        while axes and axes[-1] is None:
            axes.pop()
        assert str(ours[name]) == str(sharding.PartitionSpec(*axes)), name


ZERO_CASES = [
    # (params, param specs, mesh) of the JAX package's policy tests.
    ({"w": (8, 4096), "b": (16,)}, None, {"dp": 2}),
    ({"w": (8, 4096)}, None, {"dp": 2}),
    ({"w": (8, 4096)}, {"w": ("None", "tp")}, {"dp": 2, "tp": 2}),
    ({"w": (8, 4096)}, {"w": ("None", "fsdp")}, {"dp": 1, "fsdp": 2}),
    ({"odd": (3, 1025)}, None, {"dp": 2}),
    ({"w": (8, 4096)}, None, {"dp": 1}),
]


@pytest.mark.parametrize("case", range(len(ZERO_CASES)))
def test_zero_policy_cases_equal_the_jax_policy(case, caplog):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from accelerate_tpu import MeshConfig
    from accelerate_tpu.parallel.sharding import infer_opt_state_shardings as jax_opt

    shapes, specs, axes = ZERO_CASES[case]
    n = int(np.prod(list(axes.values())))
    mesh = MeshConfig(**axes, devices=jax.devices()[:n]).build()
    params = {k: jnp.zeros(s) for k, s in shapes.items()}
    p_sh = None if specs is None else {
        k: NamedSharding(mesh, PartitionSpec(*(None if a == "None" else a for a in v)))
        for k, v in specs.items()}
    opt_state = optax.adam(1e-3).init(params)
    caplog.set_level(logging.INFO)
    jopt = jax_opt(opt_state, mesh, params=params, param_shardings=p_sh)
    ours = sharding.infer_opt_state_shardings(
        paths_and_shapes(opt_state), axes, params=paths_and_shapes(params),
        param_shardings=None if specs is None else [
            tuple(None if a == "None" else a for a in specs[k]) for k in sorted(params)])
    assert [str(s) for s in ours.values()] == jax_specs(jopt)
    assert report(caplog, "accelerate_tpu_torch.parallel.sharding") == report(
        caplog, "accelerate_tpu.parallel.sharding")


def test_tensor_and_pipeline_rules_need_a_mesh():
    """The tp, pp and ep rules act only with their plugin on a mesh whose
    axis is above 1; HYBRID_SHARD is FULL_SHARD's policy."""
    from accelerate_tpu_torch import (
        ExpertParallelPlugin,
        PipelineParallelPlugin,
        TensorParallelPlugin,
    )

    q = "model/blocks/self_attn/q_proj/kernel"
    tp = TensorParallelPlugin(tp_size=2)
    pp = PipelineParallelPlugin(pp_size=2)
    assert sharding.infer_param_shardings([(q, (2, 8, 8))], {"fsdp": 2}, tp_plugin=tp,
                                          pp_plugin=pp)[q] == sharding.PartitionSpec()
    got = sharding.infer_param_shardings([(q, (2, 8, 8))], {"tp": 2, "pp": 2}, tp_plugin=tp,
                                         pp_plugin=pp)[q]
    assert str(got) == "PartitionSpec('pp', None, 'tp')"
    experts = "layers_0/mlp/experts/gate_proj"
    ep = ExpertParallelPlugin(ep_size=2)
    assert sharding.infer_param_shardings([(experts, (4, 8, 8))], {"ep": 2})[experts] == \
        sharding.PartitionSpec()
    got = sharding.infer_param_shardings([(experts, (4, 8, 8))], {"ep": 2}, ep_plugin=ep)
    assert str(got[experts]) == "PartitionSpec('ep',)"
    hybrid = FullyShardedDataParallelPlugin(sharding_strategy="HYBRID_SHARD")
    assert hybrid.reshard_after_forward and hybrid.min_weight_size_to_shard == 2**14


def test_plugins_read_the_environment_and_translate_like_the_jax_package(monkeypatch):
    from accelerate_tpu.utils import DeepSpeedPlugin as JaxDeepSpeed
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP

    fields = ("sharding_strategy", "reshard_after_forward", "cpu_offload",
              "activation_checkpointing", "zero_sharding", "min_weight_size_to_shard")
    for env in ({}, {"FSDP_SHARDING_STRATEGY": "SHARD_GRAD_OP", "FSDP_OFFLOAD_PARAMS": "true",
                     "FSDP_ACTIVATION_CHECKPOINTING": "1", "FSDP_ZERO_SHARDING": "true",
                     "FSDP_MIN_NUM_PARAMS": "4096"}, {"FSDP_SHARDING_STRATEGY": "NO_SHARD"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            ours, ref = FullyShardedDataParallelPlugin(), JaxFSDP()
        assert [getattr(ours, f) for f in fields] == [getattr(ref, f) for f in fields], env
    with pytest.warns(UserWarning, match="param_dtype"):
        FullyShardedDataParallelPlugin(param_dtype="bf16")
    with pytest.warns(UserWarning, match="auto_wrap_policy"):
        FullyShardedDataParallelPlugin(auto_wrap_policy=object())
    for stage in range(4):
        for offload in ("none", "cpu"):
            ours = DeepSpeedPlugin(zero_stage=stage, offload_optimizer_device=offload)
            ref = JaxDeepSpeed(zero_stage=stage, offload_optimizer_device=offload)
            got, want = ours.to_fsdp_plugin(), ref.to_fsdp_plugin()
            assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


@pytest.mark.parametrize("scheduler", [
    {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                    "warmup_num_steps": 10}},
    {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-5, "warmup_max_lr": 2e-3,
                                    "warmup_num_steps": 8, "warmup_type": "linear"}},
    {"type": "WarmupDecayLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                         "warmup_num_steps": 5, "total_num_steps": 17}},
])
def test_deepspeed_schedule_equals_the_jax_plugin(tmp_path, scheduler):
    from accelerate_tpu.utils import DeepSpeedPlugin as JaxDeepSpeed

    config = {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
              "gradient_clipping": 1.0, "scheduler": scheduler,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(config))
    ours, ref = DeepSpeedPlugin(config_file=str(path)), JaxDeepSpeed(hf_ds_config=config)
    assert (ours.zero_stage, ours.offload_optimizer_device, ours.gradient_clipping) == (
        ref.zero_stage, ref.offload_optimizer_device, ref.gradient_clipping) == (2, "cpu", 1.0)
    mine, theirs = ours._schedule_fn(), ref._schedule_fn()
    np.testing.assert_allclose([mine(s) for s in range(21)],
                               [float(theirs(s)) for s in range(21)], rtol=1e-6, atol=1e-12)
    # As a torch scheduler: prepared, it writes the rate the schedule gives.
    acc = Accelerator(cpu=True, deepspeed_plugin=ours)
    model = torch.nn.Linear(4, 4)
    opt = ours.build_optimizer(model.parameters())
    assert isinstance(opt, torch.optim.AdamW) and opt.defaults["weight_decay"] == 0.01
    model, opt, sched = acc.prepare(model, opt, ours.build_scheduler())
    for _ in range(3):
        acc.backward(lambda p, b: p["weight"].sum(), None)
        opt.step()
        sched.step()
        opt.zero_grad()
    assert opt.param_groups[0]["lr"] == pytest.approx(mine(3), rel=1e-12)
    assert str(acc.distributed_type) == "DEEPSPEED" and acc.zero_sharding


def test_host_offload_helpers_round_trip():
    tree = {"x": torch.arange(8.0).reshape(2, 4), "n": 3, "l": [torch.ones(2)]}
    assert host_offload.supports_host_memory("cpu")
    assert host_offload.tree_memory_kinds(tree) == {"device"}
    host = host_offload.to_host(tree)
    assert host_offload.tree_memory_kinds(host) == {"unpinned_host"} and host["n"] == 3
    back = host_offload.to_device(host, "cpu")
    assert host_offload.tree_memory_kinds(back) == {"device"}
    assert torch.equal(back["x"], tree["x"]) and back["x"] is not host["x"]
    assert host_offload.memory_kind_of(3) is None
    with pytest.raises(ValueError, match="memory kind"):
        host_offload.put_tree(tree, "hbm")


def tiny_run(plugin=None, steps=4, eager=False, seed=0):
    """The tiny stacked Llama on the CPU: ``steps`` AdamW updates (fused,
    or ``backward`` + ``step`` with ``eager``), one fixed batch; returns
    (losses, model, optimizer, accelerator)."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True, fsdp_plugin=plugin)
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                      generator=torch.Generator().manual_seed(seed))
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    loss_fn = fused_causal_lm_loss(model)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (4, 16)))
    losses = []
    if eager:
        for _ in range(steps):
            losses.append(acc.backward(loss_fn, {"input_ids": ids}).item())
            acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            opt.zero_grad()
    else:
        step = acc.compile_train_step(loss_fn, max_grad_norm=1.0)
        losses = [step({"input_ids": ids})["loss"].item() for _ in range(steps)]
    return losses, model, opt, acc


@pytest.mark.parametrize("plugin", [
    dict(cpu_offload=True), dict(sharding_strategy="FULL_SHARD", activation_checkpointing=True,
                                 zero_sharding=True),
    dict(sharding_strategy="SHARD_GRAD_OP", activation_checkpointing=True,
         remat_policy="nothing", zero_sharding=True, cpu_offload=True),
    dict(sharding_strategy="NO_SHARD", zero_sharding=True)], ids=str)
def test_every_mode_follows_the_unsharded_trajectory_at_one_process(plugin):
    reference = tiny_run()[0]
    losses, model, opt, _ = tiny_run(FullyShardedDataParallelPlugin(**plugin))
    assert losses == reference
    layers = LlamaConfig.tiny().num_hidden_layers
    strategy = plugin.get("sharding_strategy", "FULL_SHARD")
    per_step = 0 if strategy == "NO_SHARD" else (
        2 if strategy == "FULL_SHARD" and plugin.get("activation_checkpointing") else 1)
    assert model.layout.gathers == per_step * layers * len(losses)
    kinds = opt.state_memory_kinds()
    assert kinds == ({"unpinned_host"} if plugin.get("cpu_offload") else {"device"})


def test_offload_keeps_the_state_on_the_host_in_the_loop_and_through_state_dict():
    reference = tiny_run(eager=True, steps=3)[0]
    losses, model, opt, acc = tiny_run(FullyShardedDataParallelPlugin(cpu_offload=True),
                                       eager=True, steps=3)
    assert losses == reference and opt.offload_to_host
    assert opt.state_memory_kinds() == {"unpinned_host"}
    assert {host_offload.memory_kind_of(p) for p in model.parameters()} == {"device"}
    sd = opt.state_dict()
    opt.load_state_dict(sd)
    assert opt.state_memory_kinds() == {"unpinned_host"}
    assert opt.state_bytes() == 2 * sum(p.numel() * 4 for p in model.parameters())
    # DeepSpeed's offload_optimizer device "cpu" is the same option.
    from accelerate_tpu_torch.state import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, deepspeed_plugin=DeepSpeedPlugin(
        zero_stage=2, offload_optimizer_device="cpu"))
    assert acc.fsdp_plugin.cpu_offload and acc.zero_sharding
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    step = acc.compile_train_step(fused_causal_lm_loss(model))
    loss = step({"input_ids": torch.zeros(2, 8, dtype=torch.long)})["loss"]
    assert torch.isfinite(loss) and opt.offload_to_host
    assert opt.state_memory_kinds() == {"unpinned_host"}


def test_frozen_parameters_get_no_state_under_zero():
    """The JAX package's LoRA case: a frozen leaf has no moments (no view
    either), stays bit-identical, and the trainable ones train."""
    from accelerate_tpu_torch.test_utils.training import RegressionModel, init_mlp, mse_loss

    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(
        sharding_strategy="NO_SHARD", zero_sharding=True))
    model = RegressionModel(init_mlp(0, dh=512))
    model.w1.requires_grad_(False)
    frozen = model.w1.detach().clone()
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2))
    assert opt._views == [] and opt.opt_state_shardings is not None
    step = acc.compile_train_step(mse_loss, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 4)).astype(np.float32))
    batch = {"x": x, "y": x @ torch.tensor([[1.0], [-2.0], [0.5], [3.0]])}
    losses = [step(batch)["loss"].item() for _ in range(4)]
    assert losses[-1] < losses[0]
    assert torch.equal(model.module.w1, frozen)
    assert model.module.w1 not in opt.optimizer.state


def test_merge_weights_merges_a_sharded_save_model_export(tmp_path, monkeypatch, capsys):
    from accelerate_tpu_torch.checkpointing import load_safetensors, save_safetensors
    from accelerate_tpu_torch.commands import accelerate_cli

    d = tmp_path / "src"
    d.mkdir()
    save_safetensors({"a.w": torch.ones(2, 2)}, d / "model-00001-of-00002.safetensors")
    save_safetensors({"b.w": torch.zeros(3)}, d / "model-00002-of-00002.safetensors")
    (d / "model.safetensors.index.json").write_text(json.dumps({
        "weight_map": {"a.w": "model-00001-of-00002.safetensors",
                       "b.w": "model-00002-of-00002.safetensors"}}))
    out = tmp_path / "merged.safetensors"
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "merge-weights", str(d), str(out)])
    assert accelerate_cli.main() == 0
    merged = load_safetensors(out)
    assert set(merged) == {"a.w", "b.w"} and torch.equal(merged["a.w"], torch.ones(2, 2))
    assert "Merged 2 tensors" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "merge-weights",
                                     str(tmp_path / "nowhere"), str(out)])
    assert accelerate_cli.main() == 2


def test_launch_fsdp_asks_the_children_for_fsdp(tmp_path, monkeypatch):
    from accelerate_tpu_torch.commands import launch
    from accelerate_tpu_torch.state import AcceleratorState

    (tmp_path / "s.py").write_text("")
    seen = {}

    class Done:
        returncode = 0

    monkeypatch.setattr(launch.subprocess, "run",
                        lambda cmd, env: seen.update(env=env) or Done())
    args = launch.launch_command_parser().parse_args(
        ["--use_cpu_emulation", "--fsdp", "-1", str(tmp_path / "s.py")])
    assert launch.launch_command(args) == 0
    assert seen["env"]["ACCELERATE_TPU_MESH_FSDP"] == "-1"
    monkeypatch.setenv("ACCELERATE_TPU_MESH_FSDP", "-1")
    state = AcceleratorState(cpu=True)
    assert state.fsdp_plugin.sharding_strategy == "FULL_SHARD"
    assert str(state.distributed_type) == "FSDP"
    AcceleratorState._reset_state(reset_partial_state=True)
    monkeypatch.setenv("ACCELERATE_TPU_MESH_FSDP", "2")
    with pytest.raises(ValueError, match="1 devices not divisible by explicit axes product 2"):
        AcceleratorState(cpu=True)
