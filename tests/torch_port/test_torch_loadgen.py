"""The load generator (``accelerate_tpu_torch/loadgen``) and the
``serve``/``loadtest`` commands on the CPU. Schedules, request shapes and
reports are identical to the JAX package's from the same seeds and the
same stream results; the commands run end to end."""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu import loadgen as jax_loadgen
from accelerate_tpu.commands.loadtest import _parse_priorities as jax_parse_priorities
from accelerate_tpu_torch import loadgen
from accelerate_tpu_torch.commands import accelerate_cli
from accelerate_tpu_torch.commands.loadtest import (
    _parse_priorities,
    loadtest_command,
    loadtest_command_parser,
)
from accelerate_tpu_torch.commands.serve import serve_command, serve_command_parser
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.serving import GatewayConfig, ReplicaSet, ServingGateway

from torch_fleet_common import port_engine, post
from torch_serving_common import WAIT

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("dist, kw", [("lognormal", dict(sigma=1.3)),
                                      ("pareto", dict(alpha=1.6)), ("uniform", {})])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_schedules_are_the_jax_schedules(dist, kw, seed):
    port = loadgen.ArrivalSchedule(200, 0.01, dist=dist, seed=seed, **kw)
    ref = jax_loadgen.ArrivalSchedule(200, 0.01, dist=dist, seed=seed, **kw)
    np.testing.assert_array_equal(port.offsets(), ref.offsets())
    assert port.describe() == ref.describe()
    assert port.offsets()[0] == 0.0 and np.all(np.diff(port.offsets()) >= 0)


def test_traffic_profiles_sample_the_jax_requests():
    kw = dict(prompt_len_median=12, prompt_len_max=40, out_tokens_median=6, out_tokens_max=20,
              adapters=((None, 2.0), ("a", 1.0)), sampled_fraction=0.3,
              priorities=(("interactive", 0.5), ("batch", 0.5)), timeout_s=5.0, seed=4)
    port, ref = loadgen.TrafficProfile(**kw), jax_loadgen.TrafficProfile(**kw)
    assert [port.sample(300) for _ in range(60)] == [ref.sample(300) for _ in range(60)]
    assert port.describe() == ref.describe()


def stream_results(package):
    """One of each outcome: completed (with and without token gaps), a 429
    with and without Retry-After, a 503, a truncated stream, an abort, a
    connect failure, an unstructured 500 and a token mismatch."""
    R = package.StreamResult
    done = {"status": "completed", "tokens": [1, 2, 3]}
    return [
        R(0, 0.0, 0.001, 200, 0.05, [0.01, 0.02], [1, 2, 3], done,
          request={"priority": "interactive"}),
        R(1, 0.01, 0.011, 200, 0.2, [0.03, 0.04], [1, 2, 3], done,
          request={"priority": "batch"}),
        R(2, 0.02, 0.021, 429, retry_after_s=2.0, request={"priority": "batch"}),
        R(3, 0.03, 0.031, 429, request={}),
        R(4, 0.04, 0.041, 503, retry_after_s=1.0),
        R(5, 0.05, 0.051, 200, 0.1, [], [1], truncated=True),
        R(6, 0.06, 0.061, 200, aborted=True),
        R(7, 0.07, error="connect: OSError"),
        R(8, 0.08, 0.081, 500, done={"status": "failed"}),
        R(9, 0.09, 0.091, 200, 0.3, [0.05], [1, 9], {"status": "completed", "tokens": [1, 2]},
          heartbeats=2),
    ]


def test_reports_are_the_jax_reports():
    sched = dict(n=10, mean_interarrival_s=0.01, seed=3)
    prof = dict(seed=5)
    reports = {}
    for name, pkg in (("port", loadgen), ("jax", jax_loadgen)):
        run = {"results": stream_results(pkg), "wall_s": 1.5, "process_cpu_s": 0.4}
        reports[name] = pkg.build_report(run, pkg.ArrivalSchedule(**sched),
                                         pkg.TrafficProfile(**prof), slo_ttft_s=0.25,
                                         server_metrics={"open_sse_streams": 0.0})
    assert json.dumps(reports["port"], sort_keys=True) == json.dumps(reports["jax"], sort_keys=True)
    conf = reports["port"]["conformance"]
    assert conf["missing_retry_after"] == 1 and conf["unstructured_non_2xx"] == 1
    assert conf["token_mismatches"] == 1 and reports["port"]["counters_balance"]
    for q in (0.0, 50.0, 99.0, 99.9, 100.0):
        values = [0.3, float("inf"), 0.1, 0.2, 0.5]
        assert loadgen.percentile(values, q) == jax_loadgen.percentile(values, q)
    assert loadgen.percentile([], 50.0) is None


def test_open_loop_run_against_the_port_gateway():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    fleet = ReplicaSet.from_factory(
        lambda: port_engine(model, max_slots=2, max_len=64, prefill_chunk=16), 2)
    sched = loadgen.ArrivalSchedule(12, 0.005, dist="pareto", alpha=1.6, seed=1)
    prof = loadgen.TrafficProfile(prompt_len_median=6, prompt_len_max=16, out_tokens_median=5,
                                  out_tokens_max=10, seed=2)
    with ServingGateway(fleet, config=GatewayConfig(port=0)) as gw:
        run = loadgen.run_open_loop(gw.url, sched, prof, wall_deadline_s=WAIT)
        report = loadgen.build_report(run, sched, prof,
                                      server_metrics=loadgen.fetch_gateway_metrics(gw.url))
    assert report["goodput"]["completed"] == 12 and report["counters_balance"]
    assert report["conformance"]["token_mismatches"] == 0
    assert report["conformance"]["truncated_sse"] == 0
    assert report["server_metrics"]["open_sse_streams_max"] >= 1


def test_priority_specs_parse_like_the_jax_command():
    for spec in ("interactive=0.2,batch=0.8", " a=1 , b=2 "):
        assert _parse_priorities(spec) == jax_parse_priorities(spec)
    for bad in ("", "interactive", "=0.5", "a=", "a=zero", "a=0", "a=-1"):
        with pytest.raises(SystemExit):
            _parse_priorities(bad)


LOADTEST = ["--device", "cpu", "--n-streams", "8", "--rps", "50", "--prompt-len", "4",
            "--prompt-max", "8", "--out-tokens", "4", "--out-max", "8", "--wall-deadline", "30"]


def test_loadtest_check_passes_on_a_tiny_self_hosted_fleet(tmp_path):
    out = tmp_path / "report.json"
    args = loadtest_command_parser().parse_args(
        LOADTEST + ["--priorities", "interactive=0.5,batch=0.5", "--output", str(out), "--check"])
    assert loadtest_command(args) == 0
    report = json.loads(out.read_text())
    assert report["goodput"]["completed"] == 8 and report["counters_balance"]
    assert set(report["per_priority"]) <= {"interactive", "batch"}
    assert sum(pr["offered"] for pr in report["per_priority"].values()) == 8


def test_loadtest_check_fails_with_the_reference_exit_code(monkeypatch, tmp_path):
    """A violated limit: the JAX command exits 1 under ``--check``."""
    real = loadgen.build_report

    def tainted(*a, **kw):
        rep = real(*a, **kw)
        rep["conformance"]["token_mismatches"] += 1
        return rep

    monkeypatch.setattr("accelerate_tpu_torch.loadgen.build_report", tainted)
    args = loadtest_command_parser().parse_args([
        "--device", "cpu", "--n-streams", "2", "--rps", "50", "--prompt-len", "4",
        "--prompt-max", "8", "--out-tokens", "2", "--out-max", "4", "--wall-deadline", "30",
        "--output", str(tmp_path / "r.json"), "--check"])
    assert loadtest_command(args) == 1


def test_serve_refuses_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        serve_command(serve_command_parser().parse_args(["--model", "tiny"]))
    with pytest.raises(SystemExit, match="one process per tp index"):
        serve_command(serve_command_parser().parse_args(["--tp", "2", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="tiny"):
        serve_command(serve_command_parser().parse_args(["--model", "nonsense",
                                                         "--device", "cpu"]))
    assert set(accelerate_cli._subcommand_registrars()) == {
        "config", "env", "launch", "loadtest", "merge-weights", "serve", "test"}


def test_serve_answers_and_drains_on_sigterm():
    """``accelerate-tpu-torch serve --model tiny --device cpu`` as a process:
    it answers a completion, then exits 0 on SIGTERM after draining."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "serve",
         "--model", "tiny", "--device", "cpu", "--port", "0", "--replicas", "2",
         "--supervise", "--max-len", "64", "--prefill-chunk", "16"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(WAIT, proc.kill)  # bounds the reads below
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                break
        url = lines[-1].split()[2]
        assert any("supervisor on" in ln for ln in lines), lines
        code, body, _ = post(url, {"prompt": [1, 2, 3], "max_new_tokens": 4})
        assert code == 200 and body["status"] == "completed" and len(body["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=WAIT)
        assert proc.returncode == 0, rest
        assert "gateway drained; bye" in rest
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
