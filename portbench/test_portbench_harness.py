"""The harness: cells, configurations, traffic kinds and metrics found by
name from files alone; the result line's keys; the refusals (no card, a
forbidden module)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core
from portbench.tiny import TINY

ROOT = Path(__file__).resolve().parent.parent

TOY_KIND = '''
def run(cell):
    cell.attempted, cell.failed = 3, 0
    cell.end_to_end = {"toy_rate": cell.config["width"] * cell.params["scale"], "setup_s": 0.5}
    cell.counters = {"toy": cell.seed}
    cell.checks = {"correct": True, "lines": {"toy_gap": {"value": 0.0, "limit": 0.1}}}
'''

TOY_METRIC = '''
def read(cell):
    return cell.counters["toy"] + 0.5
'''

SILENT_METRIC = '''
def read(cell):
    return None
'''


@pytest.fixture
def extended(tmp_path):
    """A copy of the benchmark with a configuration, a cell, a traffic kind
    and two metrics added as files and entries, no existing file edited
    but ``BENCHMARK.json`` (which gains entries)."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "portbench/configs/toy.json").write_text(json.dumps({"width": 3}))
    (tmp_path / "portbench/workloads/toy-cell.json").write_text(json.dumps(
        {"config": "toy", "traffic": "toymix", "kind": "toy_kind", "chips": 1,
         "why": "a toy", "params": {"scale": 2}, "limits": {}}))
    (tmp_path / "portbench/traffic/toy_kind.py").write_text(TOY_KIND)
    (tmp_path / "portbench/metrics/toy.layer_ms.py").write_text(TOY_METRIC)
    (tmp_path / "portbench/metrics/toy.silent.py").write_text(SILENT_METRIC)
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "portbench/configs/toy.json", "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toymix",
                               "chips": 1, "why": "a toy"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["toy-cell"]})
    for name in ("toy.layer_ms", "toy.silent"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "program_counter", "layer": "toy layer",
                                   "moves": "toy_rate", "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())
    return core.Bench.at(tmp_path)


def test_a_cell_added_as_files_runs(extended):
    line = core.run_cell(extended, "toy-cell", 7, 1.0, False, device="cpu")
    assert line["metrics"] == {"toy_rate": {"value": 6.0, "unit": "1/s"},
                               "setup_s": {"value": 0.5, "unit": "s"}}
    assert line["correct"] is True and line["attempted"] == 3


def test_a_metric_added_as_a_file_is_read_and_a_silent_one_left_out(extended):
    line = core.run_cell(extended, "toy-cell", 7, 1.0, True, device="cpu")
    assert line["metrics"] == {"toy.layer_ms": {"value": 7.5, "unit": "ms"}}


def test_metrics_of_follow_the_workloads_key(extended):
    names = [m["name"] for m in extended.metrics_of("mixtral-train-packed4k", False)]
    assert names == ["train_tokens_per_s", "setup_s"]
    layer = [m["name"] for m in extended.metrics_of("toy-cell", True)]
    assert layer == ["toy.layer_ms", "toy.silent"]


def test_the_result_line_keys(extended):
    line = core.run_cell(extended, "toy-cell", 7, 1.0, False, device="cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"] == {"toy_gap": {"value": 0.0, "limit": 0.1}}


def test_every_benchmark_entry_has_its_files():
    bench = core.Bench.at(ROOT)
    for w in bench.benchmark["workloads"]:
        spec = bench.workload(w["name"])
        assert (bench.dir / "traffic" / f"{spec['kind']}.py").is_file()
        assert bench.config(spec["config"])
    for m in bench.benchmark["per_layer"]:
        assert callable(bench.reader(m["name"]).read)


def test_a_traced_line_has_the_device_window_and_breakdown():
    bench = core.Bench.at(ROOT)
    line = core.run_cell(bench, "mistral-serve-chat", 11, 2.0, True, device="cpu",
                         overrides=TINY["mistral-serve-chat"])
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # CPU runs read no device metric.
    assert not any(k in line["metrics"] for k in ("serve.decode_tick_ms", "serve.decode_mfu"))


def _python(code, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "HOME": str(ROOT)}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env={**env, **(env_extra or {})})


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mixtral-train-packed4k", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is missing, the run fails and prints nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys; sys.argv = ['run.py', '--workload', 'mixtral-train-packed4k', "
            "'--seed', '1', '--seconds', '1']; sys.path.insert(0, '.'); "
            "from portbench import run, core; core.require_card = lambda chips: None; "
            "sys.exit(run.main())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "accelerate_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", ["mixtral-train-packed4k", "mistral-serve-chat"])
def test_a_run_loads_no_forbidden_module(cell):
    """Every module a run of each cell imports, by top-level name whole:
    ``accelerate_tpu_torch`` is the program, ``accelerate_tpu`` is not."""
    code = (f"import json; from portbench import core, tiny; "
            f"b = core.Bench.at('.'); "
            f"core.run_cell(b, {cell!r}, 3, 1.0, False, device='cpu', "
            f"overrides=tiny.TINY[{cell!r}]); import sys; "
            f"print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "accelerate_tpu_torch" in tops
    assert not tops & set(core.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    code = ("import sys, types; from portbench import core; "
            "sys.modules['accelerate_tpu_torch_extra'] = types.ModuleType('x'); "
            "sys.modules['jaxtyping'] = types.ModuleType('x'); "
            "a = core.forbidden_modules(); "
            "sys.modules['jax.numpy'] = types.ModuleType('x'); "
            "sys.modules['accelerate_tpu.ops'] = types.ModuleType('x'); "
            "print(a, core.forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] ['accelerate_tpu', 'jax']"


def test_a_forbidden_module_refuses_the_run(monkeypatch, extended):
    import types

    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    with pytest.raises(core.Refused, match="flax"):
        core.run_cell(extended, "toy-cell", 7, 1.0, False, device="cpu")

