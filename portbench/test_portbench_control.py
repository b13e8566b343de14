"""The controls: computed in the precision below the configuration's, each
cell's comparison must fail.

On the card (marked ``card``) at the cells' own sizes on three seeds, as
``python3 portbench/controls.py`` reads them: the training control (the
program's fp8 path) and the half-batch fault fail the training cell's
limits; the serving control (the program's engine with int8 weights and
int8 KV pages) fails the serving cell's. On the CPU, at a size it holds,
the same readings run end to end and the training control reads far above
a sound float32 run."""

from pathlib import Path

import pytest

from portbench import controls, core
from portbench.tiny import TINY, with_params

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _bench():
    return core.Bench.at(ROOT)


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[k] > limits[k] for k in limits)


def test_training_control_reads_far_above_a_sound_run():
    out = controls.train_readings(_bench(), "mixtral-train-packed4k", 5, True, "cpu",
                                  TINY["mixtral-train-packed4k"])
    for key in ("grad_gap", "change_gap"):
        assert out["control"][key] > 100 * out["sound"][key]
        assert out["half_batch"][key] > 100 * out["sound"][key]
    assert out["control_warm"]["grad_gap"] == out["control_warm"]["grad_gap"]  # a number


def test_serving_control_runs_end_to_end():
    tiny = with_params(TINY["mistral-serve-chat"], dtype="bfloat16")
    out = controls.serve_readings(_bench(), "mistral-serve-chat", 5, 1.0, True, "cpu", tiny)
    assert out["requests"] > 0 and out["served_tokens"] > 0
    for key in ("sound", "control", "control_forward"):
        assert out[key]["logit_gap"] >= out[key]["logit_gap_mean"] >= 0.0


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_fault_fail_on_the_card(card, seed):
    bench = _bench()
    limits = bench.workload("mixtral-train-packed4k")["limits"]
    out = controls.train_readings(bench, "mixtral-train-packed4k", seed, True)
    assert not _fails(out["sound"], limits), out
    assert _fails(out["control"], limits), out
    assert _fails(out["half_batch"], limits), out


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails_on_the_card(card, seed):
    bench = _bench()
    limits = bench.workload("mistral-serve-chat")["limits"]
    out = controls.serve_readings(bench, "mistral-serve-chat", seed, 10.0, True)
    assert not _fails(out["sound"], limits), out
    assert _fails(out["control"], limits), out
