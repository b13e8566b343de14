"""The port's two headline examples, ``examples/nlp_example_torch.py``
(BERT) and ``examples/cv_example_torch.py`` (ResNet), run end to end as
scripts with ``--cpu`` and held to the thresholds ``tests/test_examples.py``
holds the JAX examples to: eval_acc >= 0.8 within 5 epochs, acc >= 0.9
after one. Without ``--cpu`` they run on the card, and where there is
none (as in this suite) they fail rather than fall back to the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
EXAMPLES = REPO / "examples"


def run(script, *args, timeout=300):
    # One CPU thread: the scripts' steps are small, and beside the other
    # test workers a thread per core only contends (1 thread: ~8 s for the
    # nlp example alone, against ~14 s with one per core).
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(EXAMPLES / script), *args], capture_output=True,
                          text=True, timeout=timeout, cwd=str(REPO), env=env)


def test_nlp_example_learns_on_the_cpu():
    res = run("nlp_example_torch.py", "--cpu", "--epochs", "5", "--batch_size", "16")
    assert res.returncode == 0, res.stderr[-2000:]
    accs = [float(a) for a in re.findall(r"eval_acc (\d\.\d+) \(100 samples\)", res.stdout)]
    assert len(accs) == 5, res.stdout[-2000:]
    assert max(accs) >= 0.8, f"eval accuracy never reached 0.8: {accs}"


def test_cv_example_learns_on_the_cpu():
    res = run("cv_example_torch.py", "--cpu", "--epochs", "1", "--batch_size", "16")
    assert res.returncode == 0, res.stderr[-2000:]
    accs = [float(a) for a in re.findall(r"acc (\d\.\d+)", res.stdout)]
    assert accs and max(accs) >= 0.9, res.stdout[-1500:]


@pytest.mark.parametrize("script", ["nlp_example_torch.py", "cv_example_torch.py"])
def test_examples_need_the_card_unless_asked_for_the_cpu(script):
    res = run(script, "--epochs", "1", timeout=120)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr, res.stderr[-1500:]
