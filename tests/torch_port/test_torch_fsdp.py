"""Sharded training state across processes: FSDP and ZeRO over a gloo
world of 2 on the CPU (``parallel/sharding.py``), started through the
port's ``launch``, held against the JAX package on a 2-device ``fsdp``
mesh of emulated CPU devices.

* The tiny stacked Llama, 6 fused AdamW steps with ``max_grad_norm`` and
  uneven -100 label masks, under FULL_SHARD (launched with ``--fsdp 2``,
  the plugin from the ``FSDP_*`` variables), SHARD_GRAD_OP and NO_SHARD,
  each with ZeRO and the first two with activation checkpointing: losses
  and grad norms within 1e-5 relative of JAX's, each rank's parameter and
  Adam-moment chunks within 1e-5 (of the largest entry) of JAX's
  addressable shard on device r, and each rank's parameter and moment
  bytes equal to JAX's per-device bytes. A FULL_SHARD step gathers each
  layer twice (forward and the checkpoint's recompute), a SHARD_GRAD_OP
  step once. ``merge-weights`` of the FULL_SHARD ``save_state`` equals the
  gathered (unsharded) state dict.
* Reshard (reference ``tests/test_zero_sharding.py:199-235``): the ZeRO
  regression MLP saved by 2 processes resumes under 4 (``via_host=True``)
  and under 1 (``via_host`` left to ``world.json``), its next 6 losses
  within 2e-5 relative of the run that was not stopped; the 2 processes'
  own reload (each reads its own file) repeats them exactly. A deep,
  narrow stacked Llama whose leaves split over the layer axis follows the
  unsharded one within 1e-6.

Every child runs under a timeout (at most 120 s), in a session of its own.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
WORKER = Path(__file__).resolve().parent / "torch_fsdp_worker.py"
TIMEOUT = 120

STRATEGIES = {
    "full": dict(sharding_strategy="FULL_SHARD", zero_sharding=True, activation_checkpointing=True),
    "grad_op": dict(sharding_strategy="SHARD_GRAD_OP", zero_sharding=True,
                    activation_checkpointing=True),
    "no_shard": dict(sharding_strategy="NO_SHARD", zero_sharding=True),
}
# Layer gathers in 6 steps of the 2-layer model: forward and recompute
# under FULL_SHARD, the forward's kept under SHARD_GRAD_OP, none unsharded.
GATHERS = {"full": 24, "grad_op": 12, "no_shard": 0}


def launch(*args, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
           "--use_cpu_emulation", *args]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"timed out after {TIMEOUT} s:\n{out[-3000:]}\n{err[-3000:]}")
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def device_tree(tree, r):
    """Each leaf's addressable shard on JAX device ``r``, as numpy."""
    import jax

    device = jax.devices()[r]
    return jax.tree_util.tree_map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == device)),
        tree)


def shard_bytes(tree, r) -> int:
    import jax

    return sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(device_tree(tree, r)))


def adam_state(opt_state):
    import jax

    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= 1e-5 * scale, (what, err, scale)


@pytest.mark.parametrize("strategy", ["full", "grad_op", "no_shard"])
def test_sharded_llama_follows_the_jax_fsdp_mesh(tmp_path, strategy):
    import jax
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import MeshConfig, Model
    from accelerate_tpu.data_loader import make_global_batch as jax_make_global_batch
    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
    from accelerate_tpu.models.llama import fused_causal_lm_loss as jax_fused_causal_lm_loss
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP
    from accelerate_tpu_torch import LlamaConfig, state_dict_from_flax
    from accelerate_tpu_torch.checkpointing import load_safetensors
    from accelerate_tpu_torch.commands.merge import merge_command, merge_command_parser

    rng = np.random.default_rng(1)
    module = JaxPipelined(JaxLlamaConfig.tiny())
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(0)))
    ids = rng.integers(0, 256, (6, 4, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2).astype(np.int32)
    labels[:, :, -1] = -100
    labels[:, 0:2, 9:16] = -100  # rank 0 keeps fewer labels than rank 1
    state = state_dict_from_flax(params, LlamaConfig.tiny())
    np.savez(tmp_path / "llama_in.npz", input_ids=ids, labels=labels,
             **{f"param.{k}": v.numpy() for k, v in state.items()})

    if strategy == "full":
        flags = {"FSDP_ZERO_SHARDING": "true", "FSDP_ACTIVATION_CHECKPOINTING": "true"}
        launch("--num_processes", "2", "--fsdp", "2", str(WORKER), "llama", str(tmp_path), "env",
               env_extra=flags)
    else:
        launch("--num_processes", "2", str(WORKER), "llama", str(tmp_path), strategy)
    ranks = [np.load(tmp_path / f"llama_{r}.npz") for r in range(2)]

    acc = JaxAccelerator(mesh_config=MeshConfig(fsdp=2, devices=jax.devices()[:2]),
                         fsdp_plugin=JaxFSDP(**STRATEGIES[strategy]))
    model, opt = acc.prepare(Model(module, params), optax.adamw(1e-4))
    step = acc.compile_train_step(jax_fused_causal_lm_loss(module), max_grad_norm=1.0)
    reference = []
    for s in range(ids.shape[0]):
        m = step(jax_make_global_batch({"input_ids": ids[s], "labels": labels[s]}, acc.mesh))
        reference.append([float(m["loss"]), float(m["grad_norm"])])
    adam = adam_state(opt.opt_state)
    cfg = LlamaConfig.tiny()
    for r, got in enumerate(ranks):
        assert str(got["strategy"]) == STRATEGIES[strategy]["sharding_strategy"]
        assert bool(got["zero"]) and str(got["distributed_type"]) == "FSDP"
        np.testing.assert_allclose(got["history"], np.asarray(reference), rtol=1e-5)
        assert int(got["gathers"]) == GATHERS[strategy]
        want = state_dict_from_flax(device_tree(model.params, r), cfg)
        mu = state_dict_from_flax(device_tree(adam.mu, r), cfg)
        nu = state_dict_from_flax(device_tree(adam.nu, r), cfg)
        for name in want:
            close(got[f"param.{name}"], want[name].numpy(), f"rank {r} {name}")
            close(got[f"mu.{name}"], mu[name].numpy(), f"rank {r} mu {name}")
            close(got[f"nu.{name}"], nu[name].numpy(), f"rank {r} nu {name}")
        assert int(got["param_bytes"]) == shard_bytes(model.params, r)
        assert int(got["moment_bytes"]) == shard_bytes(adam.mu, r) + shard_bytes(adam.nu, r)
    whole = state_dict_from_flax(jax.device_get(model.params), cfg)
    for name, tensor in whole.items():
        for r in range(2):
            close(ranks[r][f"whole.{name}"], tensor.numpy(), f"whole {name}")

    if strategy == "full":
        # The chunks really are chunks: the sharded leaves' bytes halve.
        assert int(ranks[0]["param_bytes"]) < sum(t.numel() * 4 for t in whole.values())
        out = tmp_path / "merged.safetensors"
        args = merge_command_parser().parse_args([str(tmp_path / "llama_ck"), str(out)])
        assert merge_command(args) == 0
        merged = load_safetensors(out)
        assert set(merged) == {n[len("whole."):] for n in ranks[0].files
                               if n.startswith("whole.")}
        for name, tensor in merged.items():
            np.testing.assert_array_equal(tensor.numpy(), ranks[0][f"whole.{name}"])


def test_zero_checkpoint_saved_by_two_resumes_under_four_and_one(tmp_path):
    import torch

    from torch_fsdp_worker import ZERO, mlp_setup

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin

    launch("--num_processes", "2", str(WORKER), "save", str(tmp_path))
    saved = [np.load(tmp_path / f"save_{r}.npz") for r in range(2)]
    reference = saved[0]["reference"]
    for got in saved:
        assert int(got["views"]) == 1  # w1's moments split, its parameter whole
        np.testing.assert_array_equal(got["reference"], reference)
        np.testing.assert_array_equal(got["again"], reference)
        # Leaves split over the stacked layer axis train as the unsharded ones.
        np.testing.assert_allclose(got["layer_axis"], got["layer_axis_unsharded"], rtol=1e-6)

    launch("--num_processes", "4", str(WORKER), "restore", str(tmp_path))
    for r in range(4):
        got = np.load(tmp_path / f"restore_{r}.npz")["losses"]
        np.testing.assert_allclose(got, reference, rtol=2e-5)

    # One process, here: world.json names 2, so the default reads whole.
    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(**ZERO))
    model, opt, step, batch = mlp_setup(acc)
    acc.load_state(str(tmp_path / "ck"))
    got = [step(batch)["loss"].item() for _ in range(6)]
    np.testing.assert_allclose(got, reference, rtol=2e-5)
    assert opt.optimizer.state[opt._views[0][1]]["exp_avg"].shape == torch.Size([4, 512])
