"""A whole run of each cell, the look for a card skipped, at a size a CPU
holds: sound, it comes out correct; with the timed path broken underneath
(each fault the cell can have), ``correct`` comes out false."""

import pytest
import torch

from portbench import core
from portbench.tiny import TINY, with_params


def _run(cell, seed=21, seconds=1.0, trace=False, **params):
    bench = core.Bench.at(core.Path(__file__).resolve().parent.parent)
    return core.run_cell(bench, cell, seed, seconds, trace, device="cpu",
                         overrides=with_params(TINY[cell], **params))


# -- training ------------------------------------------------------------

def _state_unchanged(monkeypatch):
    """The optimizer's step returns its state unchanged."""
    from accelerate_tpu_torch.optimizer import AcceleratedOptimizer

    monkeypatch.setattr(AcceleratedOptimizer, "step", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    """Half of each batch left out, the loss the mean over the rest."""
    from accelerate_tpu_torch.accelerator import Accelerator

    backward = Accelerator.backward

    def halved(self, loss_fn, batch, *args, **kwargs):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return backward(self, loss_fn, half, *args, **kwargs)

    monkeypatch.setattr(Accelerator, "backward", halved)


def test_training_sound_run_is_correct():
    line = _run("mixtral-train-packed4k")
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_training_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    line = _run("mixtral-train-packed4k")
    assert line["correct"] is False, line["checks"]


# -- serving -------------------------------------------------------------

def _cache_unchanged(monkeypatch):
    """Each step's K/V writes undone: the cache is left as it was."""
    from accelerate_tpu_torch.models import llama

    write = llama._write_slots_and_views

    def undone(cache, *args, **kwargs):
        kept = {k: cache[k].clone() for k in ("k", "v")}
        out = write(cache, *args, **kwargs)
        for k, t in kept.items():
            cache[k].copy_(t)
        return out

    monkeypatch.setattr(llama, "_write_slots_and_views", undone)


def _token_altered(monkeypatch):
    """Every committed token replaced by the next id."""
    from accelerate_tpu_torch.serving.engine import ServingEngine

    commit = ServingEngine._commit_token

    def altered(self, req, token):
        return commit(self, req, (int(token) + 1) % 256)

    monkeypatch.setattr(ServingEngine, "_commit_token", altered)


def test_serving_sound_run_is_correct():
    line = _run("mistral-serve-chat")
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", [_cache_unchanged, _token_altered])
def test_serving_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    line = _run("mistral-serve-chat")
    assert line["correct"] is False, line["checks"]
    assert torch.isfinite(torch.tensor(line["checks"]["logit_gap_mean"]["value"]))
