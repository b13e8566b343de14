"""Composed meshes over gloo worlds on the CPU: the reference's mesh
scripts through the port's ``launch``, HYBRID_SHARD against the JAX
package, and a tensor-parallel checkpoint merged and resumed elsewhere.

* ``test_utils/scripts/test_composed_mesh.py`` at dp=2 x fsdp=2 (4
  processes; the reference's 8 devices would be 8 processes, more than
  the CPU test budget holds) and ``test_pod_shape.py`` as 2 hosts of one
  process, through ``launch --num_machines 2`` and through
  ``notebook_launcher(num_nodes=2)``.
* HYBRID_SHARD over dp=2 x fsdp=2 with ZeRO and activation checkpointing:
  6 fused AdamW steps' losses and grad norms within 1e-5 relative of
  JAX's on the same mesh, each rank's chunks as in
  ``torch_mesh_common.check_chunks``.
* A checkpoint saved under tp=2 after 3 of 6 steps: ``merge-weights``
  gives back the gathered state dict exactly, and one process resumes
  from it (``via_host``, because ``world.json`` names 2) and repeats the
  last 3 steps' losses and grad norms within 2e-5 relative of the run that
  was not stopped.

Every child runs under a timeout of 120 s in a session of its own.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
from torch_mesh_common import (
    REPO,
    TIMEOUT,
    check_chunks,
    jax_llama_run,
    launch,
    llama_inputs,
    run_worker,
)


def test_composed_mesh_script_through_launch():
    out = launch("--num_processes", "4", "--dp", "2", "--fsdp", "2", "--module",
                 "accelerate_tpu_torch.test_utils.scripts.test_composed_mesh",
                 env_extra={"FSDP_MIN_NUM_PARAMS": "64"})
    assert out.count("composed-mesh checks passed.") == 4, out[-2000:]
    assert "composed mesh: {'pp': 1, 'dp': 2, 'fsdp': 2" in out


def _two_hosts(commands, envs):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen(cmd, cwd=str(REPO), env={**env, **extra}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for cmd, extra in zip(commands, envs)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                os.killpg(p.pid, signal.SIGKILL)
            pytest.fail("a host timed out")
        assert proc.returncode == 0, outs[-1][-3000:]
    return outs


def test_pod_shape_through_launch_and_notebook_launcher():
    from accelerate_tpu_torch.launchers import _free_port

    module = "accelerate_tpu_torch.test_utils.scripts.test_pod_shape"
    port = str(_free_port())
    outs = _two_hosts(
        [[sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
          "--use_cpu_emulation", "--num_machines", "2", "--machine_rank", str(r),
          "--main_process_ip", "127.0.0.1", "--main_process_port", port, "--module", module]
         for r in range(2)], [{"ATPU_TEST_EXPECT_RANK": str(r)} for r in range(2)])
    port = str(_free_port())
    outs += _two_hosts([[sys.executable, "-m", module, "--notebook"]] * 2,
                       [{"ATPU_TEST_NB_RANK": str(r), "ATPU_TEST_NB_PORT": port}
                        for r in range(2)])
    for out in outs:
        assert "All pod-shape checks passed" in out, out[-2000:]


def test_hybrid_shard_follows_the_jax_mesh(tmp_path):
    params, ids, labels = llama_inputs(tmp_path)
    cfg = {"fsdp": "HYBRID_SHARD", "zero": True, "remat": True}
    ranks = run_worker(tmp_path, "llama", 4, ["--dp", "2", "--fsdp", "2"], cfg)
    history, model, opt = jax_llama_run(params, ids, labels, {"dp": 2, "fsdp": 2}, **cfg)
    for got in ranks:
        np.testing.assert_allclose(got["history"], history, rtol=1e-5)
        assert str(got["distributed_type"]) == "FSDP"
    check_chunks(ranks, model, opt)


def test_tensor_parallel_checkpoint_merges_and_resumes_under_one_process(tmp_path):
    import torch
    from torch_mesh_worker import llama_setup

    from accelerate_tpu_torch.checkpointing import load_safetensors
    from accelerate_tpu_torch.commands.merge import merge_command, merge_command_parser

    llama_inputs(tmp_path)
    ranks = run_worker(tmp_path, "llama", 2, ["--tp", "2"],
                       {"tp": 2, "save_at": 3, "save": "ck"})
    out = tmp_path / "merged.safetensors"
    assert merge_command(merge_command_parser().parse_args([str(tmp_path / "ck"),
                                                            str(out)])) == 0
    merged = load_safetensors(out)
    whole = {n[len("whole."):] for n in ranks[0].files if n.startswith("whole.")}
    assert set(merged) == whole
    for name, tensor in merged.items():
        np.testing.assert_array_equal(tensor.numpy(), ranks[0][f"whole.{name}"])

    acc, model, opt, step, batch, steps = llama_setup(tmp_path, {})
    acc.load_state(str(tmp_path / "ck"))
    resumed = [[m["loss"].item(), m["grad_norm"].item()]
               for m in (step(batch(s)) for s in range(3, steps))]
    np.testing.assert_allclose(resumed, ranks[0]["history"][3:], rtol=2e-5)
    assert isinstance(model.module.lm_head.weight, torch.nn.Parameter)
    assert model.module.lm_head.weight.shape == (256, 64)  # whole again
