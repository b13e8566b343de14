"""Helpers of the port's mesh tests: launching a gloo world on the CPU
(``torch_mesh_worker.py`` runs in each process), the seeded tiny stacked
Llama both packages train, and the JAX package's run of it on a mesh of
emulated CPU devices."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
TIMEOUT = 120


def launch(*args, env_extra=None, module=None):
    """``accelerate-tpu-torch launch --use_cpu_emulation ARGS``, under a
    timeout, in a session of its own; fails the test on a non-zero exit.
    Returns the standard output."""
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


def run_worker(tmp_path, mode: str, n: int, flags=(), arg=None, env_extra=None) -> list:
    """The worker's ``mode`` in a world of ``n`` with the mesh ``flags``;
    every rank's results."""
    launch("--num_processes", str(n), *flags, str(WORKER), mode, str(tmp_path),
           json.dumps(arg if arg is not None else {}), env_extra=env_extra)
    return [np.load(tmp_path / f"{mode}_{r}.npz") for r in range(n)]


def llama_inputs(tmp_path, steps: int = 6, rows: int = 8, seq: int = 16):
    """The seeded tiny stacked Llama (flax params perturbed by noise), 6
    steps of ``rows x seq`` ids and labels with uneven -100 masks, written
    to ``llama_in.npz`` in the port's layout. Returns ``(params, ids,
    labels)``."""
    import jax

    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
    from accelerate_tpu_torch import LlamaConfig, state_dict_from_flax

    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        JaxPipelined(JaxLlamaConfig.tiny()).init_params(jax.random.PRNGKey(0)))
    ids = rng.integers(0, 256, (steps, rows, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2).astype(np.int32)
    labels[:, :, -1] = -100
    labels[:, 0:2, 9:16] = -100  # the first data shard keeps fewer labels
    state = state_dict_from_flax(params, LlamaConfig.tiny())
    np.savez(tmp_path / "llama_in.npz", input_ids=ids, labels=labels,
             **{f"param.{k}": v.numpy() for k, v in state.items()})
    return params, ids, labels


def jax_llama_run(params, ids, labels, axes: dict, fsdp=None, zero=False, remat=False,
                  tp=1, pp=1, M=1, cp=1, backend="auto", inner=1024, clip=1.0,
                  model_remat=False):
    """The JAX package's 6 fused AdamW steps of the tiny stacked Llama on a
    mesh of ``axes`` over emulated CPU devices, with the plugins the
    worker's ``llama`` mode builds. Returns ``(history, model, opt)``."""
    import math

    import jax
    import optax

    from accelerate_tpu import Accelerator, MeshConfig, Model
    from accelerate_tpu.data_loader import make_global_batch
    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
    from accelerate_tpu.models.llama import fused_causal_lm_loss
    from accelerate_tpu.state import AcceleratorState
    from accelerate_tpu.utils import (
        ContextParallelPlugin,
        FullyShardedDataParallelPlugin,
        PipelineParallelPlugin,
        TensorParallelPlugin,
    )

    AcceleratorState._reset_state()
    n = math.prod(axes.values())
    plugins = {}
    if fsdp:
        plugins["fsdp_plugin"] = FullyShardedDataParallelPlugin(
            sharding_strategy=fsdp, zero_sharding=zero, activation_checkpointing=remat,
            min_weight_size_to_shard=1024)
    if tp > 1:
        plugins["tp_plugin"] = TensorParallelPlugin(tp_size=tp)
    if pp > 1:
        plugins["pp_plugin"] = PipelineParallelPlugin(pp_size=pp, num_microbatches=M)
    if cp > 1:
        plugins["cp_plugin"] = ContextParallelPlugin(cp_size=cp, ring_inner_chunk=inner)
    acc = Accelerator(mesh_config=MeshConfig(**axes, devices=jax.devices()[:n]), **plugins)
    module = JaxPipelined(JaxLlamaConfig.tiny(attention_backend=backend, remat=model_remat),
                          num_microbatches=M if pp > 1 else None)
    model, opt = acc.prepare(Model(module, params), optax.adamw(1e-4, weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(module), max_grad_norm=clip)
    history = []
    for s in range(ids.shape[0]):
        m = step(make_global_batch({"input_ids": ids[s], "labels": labels[s]}, acc.mesh))
        history.append([float(m["loss"]), float(m["grad_norm"])])
    return np.asarray(history), model, opt


def device_tree(tree, r):
    """Each leaf's addressable shard on JAX device ``r``, as numpy."""
    import jax

    device = jax.devices()[r]
    return jax.tree_util.tree_map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == device)),
        tree)


def adam_state(opt_state):
    import jax

    return next(s for s in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def port_names(tree, layers: int):
    """A flax Llama tree (stacked, ``layers`` of them on this device) as the
    port's state dict."""
    import dataclasses

    from accelerate_tpu_torch import LlamaConfig, state_dict_from_flax

    return state_dict_from_flax(tree, dataclasses.replace(LlamaConfig.tiny(),
                                                          num_hidden_layers=layers))


def close(got, want, what, tol=1e-5):
    """``got`` within ``tol`` of the largest entry of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def check_chunks(ranks, model, opt, tol=1e-5, param_tol=5e-5):
    """Each rank's parameter and Adam-moment chunks against the elements
    the JAX package's device of that rank holds: its whole arrays (in the
    torch layout) cut by the rank's splits, which the spec tests hold to
    JAX's declared ``PartitionSpec``s (after a step XLA may lay a
    replicated leaf out otherwise, so its addressable shards are not the
    declared ones). The moments are held within ``tol`` of the largest
    entry, the parameters within ``param_tol``: AdamW divides each
    gradient by its own root mean square, so an element whose gradient is
    near zero moves by up to the learning rate whichever way the rounding
    of a differently ordered sum tips it."""
    import jax

    from accelerate_tpu_torch.checkpointing import _mesh_chunk

    adam = adam_state(opt.opt_state)
    trees = {"param": port_names(jax.device_get(model.params), 2),
             "mu": port_names(jax.device_get(adam.mu), 2),
             "nu": port_names(jax.device_get(adam.nu), 2)}
    sizes = dict(model.mesh.shape)
    for r, got in enumerate(ranks):
        coords = json.loads(str(got["coords"]))
        splits = json.loads(str(got["splits"]))
        for kind, tree in trees.items():
            for name, whole in tree.items():
                split = splits["param" if kind == "param" else "moment"][name]
                want = _mesh_chunk(whole, {ax: int(d) for ax, d in split.items()}, sizes, coords)
                close(got[f"{kind}.{name}"], want.numpy(), f"rank {r} {kind} {name}",
                      param_tol if kind == "param" else tol)


