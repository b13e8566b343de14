"""The one-process ``Accelerator`` surface around the loop, on the CPU.

* ``autocast`` yields the active precision policy, as the JAX package's does.
* ``profile`` writes its traces where the JAX package's would (the
  handler's ``output_trace_dir``, else the project's ``logging_dir``, else a
  default directory), and its schedule traces only the active steps.
* SIGTERM latches ``preemption_requested``; a run that saves its state there
  and a fresh run that loads it end bit-identical to one never stopped.
* ``AcceleratedModel.load_state_dict`` round-trips and keeps the parameters a
  prepared optimizer steps.
* ``TensorBoardTracker`` writes event files whose scalars read back, and
  without the ``tensorboard`` package asking for it raises ``ImportError``.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.utils import ProfileKwargs as JaxProfileKwargs
from accelerate_tpu_torch import (
    Accelerator,
    AutocastKwargs,
    LlamaConfig,
    NumpyDataLoader,
    PipelinedLlamaForCausalLM,
    ProfileKwargs,
    ProjectConfiguration,
    TensorBoardTracker,
    annotate,
    fused_causal_lm_loss,
    save_device_memory_profile,
)
from accelerate_tpu_torch import tracking
from accelerate_tpu_torch.state import AcceleratorState, GradientState


def reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_autocast_yields_the_policy(precision):
    acc = Accelerator(cpu=True, mixed_precision=precision)
    with acc.autocast() as policy:
        assert policy is acc.policy
    with acc.autocast(AutocastKwargs(enabled=False)) as policy:
        assert policy.compute_dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)
    jax_acc = JaxAccelerator(mixed_precision=precision)
    with jax_acc.autocast() as jax_policy:
        assert jax_policy is jax_acc.policy


def files_under(path):
    return [os.path.join(d, f) for d, _, names in os.walk(path) for f in names]


def test_profile_honors_the_trace_directory_precedence(tmp_path, monkeypatch):
    """The handler's directory, then the project's logging directory, then
    ``./torch_trace``; nothing strays into another one."""
    monkeypatch.chdir(tmp_path)
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path / "proj"), logging_dir=str(tmp_path / "logs")))
    handler_dir = tmp_path / "trace_here"
    with acc.profile(ProfileKwargs(output_trace_dir=str(handler_dir))) as prof:
        torch.ones(8).sum()
        prof.step()
    assert files_under(handler_dir) and prof.trace_files
    assert not (tmp_path / "logs").exists() and not (tmp_path / "torch_trace").exists()
    with acc.profile() as prof:
        torch.ones(8).sum()
    assert files_under(tmp_path / "logs") and not (tmp_path / "torch_trace").exists()
    acc.project_configuration.logging_dir = None
    with acc.profile() as prof:
        torch.ones(8).sum()
    assert files_under(tmp_path / "torch_trace")
    # The same order in the JAX package: its handler's directory wins.
    jax_target = tmp_path / "jax_here"
    JaxAccelerator().profile(JaxProfileKwargs(output_trace_dir=str(jax_target))).__enter__() \
        .__exit__(None, None, None)
    assert files_under(jax_target)


def test_profile_schedule_traces_only_the_active_steps(tmp_path):
    """skip_first 1 + wait 1 + warmup 1, active 2: of six steps the trace
    holds steps 3 and 4 only, written once, then ``on_trace_ready``."""
    ready = []
    acc = Accelerator(cpu=True)
    handler = ProfileKwargs(output_trace_dir=str(tmp_path),
                            schedule_option={"skip_first": 1, "wait": 1, "warmup": 1, "active": 2},
                            on_trace_ready=ready.append)
    with acc.profile(handler) as prof:
        for i in range(6):
            acc.pipeline_stats.record_wait(float(i))
            with annotate(f"step_{i}"):
                torch.ones(16).cumsum(0)
            prof.step()
    assert ready == [prof] and len(prof.trace_files) == 1
    with open(prof.trace_files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {n for n in names if str(n).startswith("step_")} == {"step_3", "step_4"}
    assert [b["step"] for b in prof.step_breakdowns] == list(range(6))
    assert prof.step_breakdowns[-1]["batches_waited"] == 6
    assert prof.data_breakdown()["data_wait_ms_max"] == 5.0


def test_save_device_memory_profile_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU refusal does not apply")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        save_device_memory_profile(str(tmp_path / "memory.pickle"))


@pytest.fixture
def sigterm_restored():
    previous = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, previous)


def token_rows(n=24, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, seq).astype(np.int64)} for _ in range(n)]


def run(updates, preempt_after=None, ckpt=None, resume=False):
    """A tiny Llama loop; with ``preempt_after`` it sends itself SIGTERM
    after that update, and at the next step boundary saves and stops."""
    reset_port_state()
    acc = Accelerator(cpu=True)
    module = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    model, opt, loader = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3),
                                     NumpyDataLoader(token_rows(), batch_size=2, shuffle=True,
                                                     seed=4))
    acc.install_preemption_handler()
    done = 0
    if resume:
        acc.load_state(ckpt)
        done = opt.steps_applied
        loader = acc.skip_first_batches(loader, done)
    loss_fn, losses = fused_causal_lm_loss(model), []
    for batch in loader:
        if acc.preemption_requested:
            acc.save_state(ckpt)
            return acc, losses, None
        with acc.accumulate(model):
            losses.append(acc.backward(loss_fn, batch))
            opt.step()
            opt.zero_grad()
        done += 1
        if done == preempt_after:
            os.kill(os.getpid(), signal.SIGTERM)
        if done == updates:
            break
    return acc, losses, {n: p.detach().clone() for n, p in module.named_parameters()}


def test_sigterm_then_save_and_load_resume_exactly(tmp_path, sigterm_restored):
    assert Accelerator.PREEMPTED_EXIT_CODE == 75
    _, straight, final = run(8)
    ckpt = str(tmp_path / "ckpt")
    acc, first, stopped = run(8, preempt_after=3, ckpt=ckpt)
    assert acc.preemption_requested and stopped is None and len(first) == 3
    acc, rest, resumed = run(8, ckpt=ckpt, resume=True)
    assert not acc.preemption_requested and len(rest) == 5
    for a, b in zip(first + rest, straight):
        assert torch.equal(a, b)
    for name, tensor in final.items():
        assert torch.equal(resumed[name], tensor), name


def test_load_state_dict_round_trips_into_the_optimizer_s_parameters():
    acc = Accelerator(cpu=True)
    module = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    params = list(module.parameters())
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in params:
            p.add_(1.0)
    model.load_state_dict({k: v.numpy() for k, v in saved.items()})  # arrays load too
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]) and v.dtype == torch.float32, k
    assert all(a is b for a, b in zip(params, opt.param_groups[0]["params"]))
    ids = torch.from_numpy(np.stack([r["input_ids"] for r in token_rows(2)]))
    with acc.accumulate(model):
        acc.backward(fused_causal_lm_loss(model), {"input_ids": ids})
        opt.step()
    moved = [n for n, v in model.state_dict().items() if not torch.equal(v, saved[n])]
    assert moved and len(moved) == len(saved)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict({})


def test_tensorboard_tracker_writes_scalars_that_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = Accelerator(cpu=True, log_with="tensorboard", project_dir=str(tmp_path))
    acc.init_trackers("run", config={"lr": 0.1, "layers": 2, "name": "tiny"})
    for step, loss in enumerate([2.5, 2.0, 1.5]):
        acc.log({"loss": loss, "note": f"step {step}"}, step=step)
    tracker = acc.get_tracker("tensorboard")
    assert isinstance(tracker, TensorBoardTracker)
    acc.end_training()
    events = EventAccumulator(tracker.logging_dir)
    events.Reload()
    scalars = events.Scalars("loss")
    assert [(s.step, s.value) for s in scalars] == [(0, 2.5), (1, 2.0), (2, 1.5)]
    assert tracking.filter_trackers("all", str(tmp_path)) == ["tensorboard", "jsonl"]


def test_tensorboard_tracker_without_the_package_raises_import_error(tmp_path, monkeypatch):
    for name in ("tensorboard", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="`tensorboard` package"):
        TensorBoardTracker("run", str(tmp_path))
    acc = Accelerator(cpu=True, log_with="tensorboard", project_dir=str(tmp_path))
    acc.init_trackers("run")  # a named tracker without its package is skipped, as in JAX
    assert acc.trackers == []
    assert tracking.filter_trackers("all", str(tmp_path)) == ["jsonl"]
