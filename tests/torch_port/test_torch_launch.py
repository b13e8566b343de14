"""The port's command line and in-process launchers, and a process group of
one in this process: ``config default``, ``env``, what ``launch`` refuses
and how it is configured, ``test``'s command, ``notebook_launcher``, and the
data-parallel step inside a gloo group of one, whose losses must equal the
step's without a group bit for bit (a one-rank sum changes nothing) while
the reduction runs once a step in the configured buckets.
"""

import socket

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.commands import accelerate_cli
from accelerate_tpu_torch.commands.launch import launch_command, launch_command_parser


def parse(*argv):
    return launch_command_parser().parse_args(list(argv))


def test_config_default_writes_a_file_the_jax_package_reads(tmp_path, capsys, monkeypatch):
    from accelerate_tpu.commands.config.config_args import load_config_from_file as jload

    path = tmp_path / "default.yaml"
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "config", "default",
                                     "--config_file", str(path), "--mixed_precision", "fp16"])
    assert accelerate_cli.main() == 0
    assert str(path) in capsys.readouterr().out
    assert jload(str(path)).mixed_precision == "fp16"


def test_env_prints_versions_cards_and_config(tmp_path, capsys, monkeypatch):
    from accelerate_tpu_torch.commands.config.config_args import ClusterConfig

    path = ClusterConfig(mixed_precision="bf16").save(str(tmp_path / "c.yaml"))
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "env", "--config_file", str(path)])
    assert accelerate_cli.main() == 0
    out = capsys.readouterr().out
    for line in (f"- torch version: {torch.__version__}", "- NCCL available: False",
                 "- Card count: 0", "mixed_precision: bf16"):
        assert line in out, line


@pytest.mark.parametrize("argv,message", [
    (["script.py"], "no CUDA card is visible; pass --use_cpu_emulation"),
    (["--use_cpu_emulation", "--ep", "2", "script.py"], "do not divide the 1 process(es)"),
    (["--use_cpu_emulation", "--num_processes", "2", "--ep", "3", "script.py"],
     "do not divide the 2 process(es)"),
    (["--use_cpu_emulation", "--emulated_device_count", "2", "script.py"], "one device"),
    (["--use_cpu_emulation", "--gcloud", "script.py"], "JAX package only"),
    (["--use_cpu_emulation", "--num_processes", "2", "--num_machines", "2",
      "--main_process_ip", "127.0.0.1", "script.py"], "exclusive"),
    (["--use_cpu_emulation", "--num_machines", "2", "script.py"], "main_process_ip"),
    (["--use_cpu_emulation", "--fsdp", "2", "script.py"], "do not divide the 1 process(es)"),
    (["--use_cpu_emulation", "--num_processes", "4", "--tp", "3", "script.py"],
     "do not divide the 4 process(es)"),
    (["--use_cpu_emulation", "--num_processes", "4", "--tp", "-1", "--cp", "-1",
      "script.py"], "only one mesh axis may be -1"),
])
def test_launch_refuses(tmp_path, capsys, argv, message, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "script.py").write_text("raise SystemExit(5)\n")
    assert launch_command(parse(*argv)) == 2
    assert message in capsys.readouterr().err


def test_launch_takes_the_config_file_and_runs_alone_without_num_processes(tmp_path,
                                                                          monkeypatch):
    """Flags win over the file; without ``--num_processes`` the script runs
    in one process with no rendezvous, told to use the CPU."""
    from accelerate_tpu_torch.commands import launch
    from accelerate_tpu_torch.commands.config.config_args import ClusterConfig

    cfg_path = str(ClusterConfig(mixed_precision="fp16", use_cpu_emulation=True).save(
        str(tmp_path / "c.yaml")))
    (tmp_path / "s.py").write_text("")
    seen = {}

    class Done:
        returncode = 0

    def fake_run(cmd, env):
        seen.update(cmd=cmd, env=env)
        return Done()

    monkeypatch.setattr(launch.subprocess, "run", fake_run)
    args = parse("--config_file", cfg_path, "--mixed_precision", "bf16", str(tmp_path / "s.py"),
                 "--lr", "1")
    assert launch_command(args) == 0
    assert seen["cmd"][1:] == [str(tmp_path / "s.py"), "--lr", "1"]
    assert seen["env"]["ACCELERATE_TPU_MIXED_PRECISION"] == "bf16"
    assert seen["env"]["ACCELERATE_TPU_USE_CPU"] == "true"
    assert "ACCELERATE_TPU_COORDINATOR_ADDRESS" not in seen["env"]


def test_test_command_launches_the_omnibus_script(monkeypatch):
    from accelerate_tpu_torch.commands import test

    seen = []

    class Done:
        returncode = 0

    monkeypatch.setattr(test.subprocess, "run", lambda cmd: seen.append(cmd) or Done())
    args = test.test_command_parser().parse_args(["--cpu", "--num_processes", "2"])
    assert test.test_command(args) == 0
    assert seen[0][3:] == ["launch", "--num_processes", "2", "--use_cpu_emulation", "--module",
                           "accelerate_tpu_torch.test_utils.scripts.test_script"]


def _double(x):
    from accelerate_tpu_torch.state import AcceleratorState

    return 2 * x, AcceleratorState(cpu=True).mixed_precision


def _mesh_shape():
    from accelerate_tpu_torch.state import AcceleratorState

    return dict(AcceleratorState(cpu=True).mesh.shape)


def test_notebook_launcher_in_process_and_its_refusals():
    from accelerate_tpu_torch import notebook_launcher
    from accelerate_tpu_torch.state import AcceleratorState

    assert notebook_launcher(_double, args=(4,), mixed_precision="bf16") == (8, "bf16")
    assert not AcceleratorState._shared_state  # reset after the run
    with pytest.raises(ValueError, match="not divisible"):  # ep=2 over one process
        notebook_launcher(_mesh_shape, args=(), ep=2)
    # A mesh of one process's axes reaches the state through the environment.
    assert notebook_launcher(_mesh_shape, args=(), tp=1, cp=1) == {
        "pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "cp": 1, "tp": 1}
    with pytest.raises(ValueError, match="master_addr"):
        notebook_launcher(_double, args=(1,), num_nodes=2)


def _world_of_one(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("ACCELERATE_TPU_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("ACCELERATE_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("ACCELERATE_TPU_PROCESS_ID", "0")


def _train(bucket_cap_mb=None):
    """Three fused steps of the tiny Llama (fp32, AdamW, clip 1.0) on
    seeded batches; returns the losses, grad norms and the accelerator."""
    from accelerate_tpu_torch import (
        Accelerator,
        DistributedDataParallelKwargs,
        LlamaConfig,
        PipelinedLlamaForCausalLM,
        fused_causal_lm_loss,
    )

    handlers = [DistributedDataParallelKwargs(bucket_cap_mb=bucket_cap_mb)] \
        if bucket_cap_mb else []
    acc = Accelerator(cpu=True, kwargs_handlers=handlers)
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, 256, (2, 16)))
        labels = ids.roll(-1, 1).masked_fill(torch.from_numpy(rng.random((2, 16)) < 0.3), -100)
        m = step({"input_ids": ids, "labels": labels})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out, acc


def test_one_rank_process_group_changes_no_bit_and_reduces_once_a_step(monkeypatch):
    from accelerate_tpu_torch.accelerator import _reduce_gradients
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import DistributedType

    alone, acc = _train()
    assert acc.distributed_type == DistributedType.NO
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    _world_of_one(monkeypatch)
    calls = _reduce_gradients.calls
    grouped, acc = _train(bucket_cap_mb=1)
    assert acc.distributed_type == DistributedType.MULTI_CPU and acc.state.backend == "gloo"
    assert torch.distributed.get_world_size() == 1
    assert grouped == alone  # bit for bit
    assert _reduce_gradients.calls - calls == 3
    n_bytes = sum(p.numel() * 4 for p in acc._models[0].module.parameters())
    assert _reduce_gradients.buckets >= n_bytes // 2**20
    with acc.no_sync():
        before = _reduce_gradients.calls
        acc.compile_train_step(lambda p, b: sum(v.sum() for v in p.values()))({"x": 0})
        assert _reduce_gradients.calls == before  # no communication off a sync step
    AcceleratorState._reset_state(reset_partial_state=True)
    assert not torch.distributed.is_initialized()  # the reset left the group
