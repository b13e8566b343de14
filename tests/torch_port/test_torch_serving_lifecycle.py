"""The serving engine's lifecycle on the CPU: cancel, timeouts,
backpressure, drain, shutdown without drain, the preemption drain through
``Accelerator``, a killed engine, the accelerator's shared counters, the
options not ported yet (and those of ROADMAP A5/A6, which now build), and
validation. Timing-sensitive tests run a model
whose every forward sleeps, so they do not depend on the host's speed."""

import json
import time

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Accelerator, LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.serving import QueueFull, RequestStatus, ServingEngine
from accelerate_tpu_torch.utils.dataclasses import ProfileKwargs
from torch_serving_common import WAIT, make_engine, wait_until  # noqa: F401


class SlowLlama(LlamaForCausalLM):
    """A forward that takes at least ``step_s`` seconds."""

    step_s = 0.01

    def forward(self, *args, **kwargs):
        time.sleep(self.step_s)
        return super().forward(*args, **kwargs)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def slow():
    return SlowLlama(LlamaConfig.tiny(), device="cpu",
                     generator=torch.Generator().manual_seed(0)).eval()


def test_backpressure_and_cancel(slow, make_engine):
    engine = make_engine(slow, max_slots=1, max_len=64, prefill_chunk=8, max_queued=1)
    running = engine.submit([[1]], max_new_tokens=40)
    wait_until(lambda: running.status is RequestStatus.RUNNING, what="running")
    queued = engine.submit([[2]], max_new_tokens=40)
    with pytest.raises(QueueFull):
        engine.submit([[3]], max_new_tokens=5)
    assert engine.serving_metrics()["requests_rejected"] == 1
    queued.cancel()
    running.cancel()
    assert running.wait(WAIT) and queued.wait(WAIT)
    assert running.status is RequestStatus.CANCELLED and len(running.tokens) < 40
    assert queued.status is RequestStatus.CANCELLED and queued.tokens == []
    with pytest.raises(RuntimeError, match="cancelled"):
        queued.result(WAIT)


def test_timeouts_running_and_queued(slow, make_engine):
    engine = make_engine(slow, max_slots=1, max_len=64, prefill_chunk=8)
    running = engine.submit([[1]], max_new_tokens=40, timeout=0.15)
    queued = engine.submit([[2]], max_new_tokens=5, timeout=0.05)
    assert running.wait(WAIT) and queued.wait(WAIT)
    assert running.status is RequestStatus.TIMED_OUT and 1 <= len(running.tokens) < 40
    assert queued.status is RequestStatus.TIMED_OUT and queued.tokens == []
    assert engine.serving_metrics()["requests_timed_out"] == 2


@pytest.mark.parametrize("drain", [True, False], ids=["drain", "cancel"])
def test_shutdown(slow, make_engine, drain):
    engine = make_engine(slow, max_slots=1, max_len=64, prefill_chunk=8)
    reqs = [engine.submit([[i + 1]], max_new_tokens=6) for i in range(3)]
    engine.shutdown(drain=drain, timeout=WAIT)
    assert not engine.running
    want = RequestStatus.COMPLETED if drain else RequestStatus.CANCELLED
    assert all(r.wait(WAIT) for r in reqs)
    if drain:
        assert all(r.status is want and len(r.tokens) == 6 for r in reqs)
    else:
        assert reqs[-1].status is want
    with pytest.raises(RuntimeError, match="not accepting"):
        engine.submit([[1]], block=True)


def test_preemption_notice_drains_through_the_accelerator(slow, make_engine):
    acc = Accelerator(cpu=True)
    engine = make_engine(slow, max_slots=2, max_len=64, prefill_chunk=8, accelerator=acc,
                         warmup=False)
    running = [engine.submit([[i + 1]], max_new_tokens=20, ignore_eos=True) for i in range(2)]
    queued = engine.submit([[9]], max_new_tokens=20)
    wait_until(lambda: engine.free_slots == 0
               and all(r.status is RequestStatus.RUNNING for r in running), what="two running")
    acc._on_preemption_signal(None, None)  # what SIGTERM does under install_preemption_handler
    assert acc.preemption_requested
    wait_until(lambda: not engine.running, what="engine exit on preemption")
    for r in running:
        assert r.status is RequestStatus.COMPLETED and len(r.tokens) == 20
    assert queued.status is RequestStatus.CANCELLED
    with pytest.raises(RuntimeError, match="not accepting"):
        engine.submit([[1]])
    # The accelerator saw this engine's counters.
    assert acc.serving_metrics()["requests_completed"] == 2
    assert acc.serving_metrics()["requests_cancelled"] == 1


def test_accelerator_shares_the_counters(model, make_engine, tmp_path):
    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path))
    acc.init_trackers("serve")
    engine = make_engine(model, max_slots=2, max_len=64, prefill_chunk=8, accelerator=acc)
    assert engine.stats is acc.serving_stats
    engine.submit([[3, 4, 5]], max_new_tokens=5).result(WAIT)
    s = acc.serving_metrics()
    assert s["requests_completed"] == 1 and s["tokens_emitted"] == 5
    acc.log({"loss": 1.0}, step=0, include_serving=True)
    acc.end_training()
    (path,) = tmp_path.rglob("*.metrics.jsonl")
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    logged = [x for x in lines if "loss" in x]
    assert logged and logged[-1]["serving/requests_completed"] == 1
    session = acc.profile(ProfileKwargs(output_trace_dir=str(tmp_path / "trace"),
                                        schedule_option={"wait": 9, "active": 1}))
    with session as prof:
        prof.step()
    assert prof.step_breakdowns[0]["serving/requests_completed"] == 1
    assert prof.serving_breakdown()["tokens_emitted"] == 5


def test_killed_engine_fails_everything(slow, make_engine):
    engine = make_engine(slow, max_slots=1, max_len=64, prefill_chunk=8)
    running = engine.submit([[1]], max_new_tokens=40)
    queued = engine.submit([[2]], max_new_tokens=5)
    wait_until(lambda: running.status is RequestStatus.RUNNING, what="running")
    engine.kill(RuntimeError("device lost"))
    assert running.wait(WAIT) and queued.wait(WAIT)
    assert running.status is RequestStatus.FAILED and queued.status is RequestStatus.FAILED
    assert not engine.healthy and isinstance(engine.error, RuntimeError)
    assert engine.postmortem()["events"][-1]["kind"] == "fatal"
    with pytest.raises(RuntimeError, match="died"):
        engine.shutdown(timeout=WAIT)


def test_spans_and_flight_events(model, make_engine):
    engine = make_engine(model, max_slots=2, max_len=64, prefill_chunk=8)
    req = engine.submit(list(range(1, 12)), max_new_tokens=4)
    req.result(WAIT)
    names = {name for _, _, _, name, _, _, _ in engine.trace_events(req.trace_id)}
    assert {"submit", "prefill_chunk", "queue_wait", "first_token", "itl", "retire"} <= names
    trace = engine.chrome_trace(req.trace_id)
    assert trace["traceEvents"]
    assert [e["kind"] for e in engine.flight_recorder.snapshot()][:1] == ["admission"]


@pytest.mark.parametrize("kwargs, item", [
    (dict(draft_model="draft"), "A5"), (dict(spec_lookup=2), "A5"),
    (dict(kv_dtype="int8"), "A5"), (dict(prefill_chunk=None), "A5"),
    (dict(adapters="bank"), "A6"), (dict(weights_dtype="int8"), "A6"),
    (dict(chaos="schedule"), "A7"), (dict(trace_dir="/nowhere"), "A7"),
    (dict(tp=2), "A8"), (dict(mesh="mesh"), "A8"), (dict(devices=["d"]), "A8")])
def test_options_not_ported_name_their_roadmap_item(model, kwargs, item, tmp_path):
    """A8 options raise, naming their ROADMAP item. The A5, A6 and A7
    options, which this test once saw refused, now build an engine that
    reports them (the placeholders stand for a draft model, a bank, a
    chaos schedule and a trace directory)."""
    if item == "A8":
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, {item}"):
            ServingEngine(model, device="cpu", autostart=False, **kwargs)
        return
    from accelerate_tpu_torch.adapters import AdapterBank
    from accelerate_tpu_torch.serving import ChaosSchedule

    stand_in = {"draft": model, "bank": AdapterBank(model, max_adapters=2),
                "schedule": ChaosSchedule().kill(at_tick=5), "/nowhere": str(tmp_path / "trace")}
    kwargs = {k: stand_in.get(v, v) if isinstance(v, str) else v for k, v in kwargs.items()}
    engine = ServingEngine(model, device="cpu", autostart=False, **kwargs)
    engine.shutdown()
    assert engine._chaos is kwargs.get("chaos")
    if "trace_dir" in kwargs:  # a shutdown writes the span and flight dumps
        assert sorted(p.name.split("-", 2)[-1] for p in (tmp_path / "trace").iterdir()) \
            == ["flight.json", "trace.json"]
    if "draft_model" in kwargs or "spec_lookup" in kwargs:
        assert engine._spec_mode == ("draft" if "draft_model" in kwargs else "lookup")
    assert engine.kv_dtype == kwargs.get("kv_dtype")
    assert engine.weights_dtype == kwargs.get("weights_dtype")
    assert engine.adapters is kwargs.get("adapters")
    assert engine.paged is ("prefill_chunk" not in kwargs)


def test_ring_models_wait_for_page_freeing():
    """A window narrower than max_len: the paged engine serves it and frees
    out-of-window pages; dense slot rows cannot rotate a ring and raise."""
    ring = LlamaForCausalLM(LlamaConfig.tiny(sliding_window=16), device="cpu")
    with pytest.raises(NotImplementedError, match="paged engine"):
        ServingEngine(ring, max_len=64, paged=False, device="cpu", autostart=False)
    engine = ServingEngine(ring, max_len=64, prefill_chunk=8, device="cpu", autostart=False)
    engine.shutdown()
    assert engine._page_window == 16
    wide = LlamaForCausalLM(LlamaConfig.tiny(sliding_window=64), device="cpu")
    engine = ServingEngine(wide, max_len=64, device="cpu", autostart=False)
    engine.shutdown()  # a window as wide as max_len is full attention
    assert engine._page_window is None


def test_validation(model, make_engine):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)  # cuda by default, and this box has no card
    with pytest.raises(ValueError, match="page_size"):
        ServingEngine(model, device="cpu", prefill_chunk=16, page_size=6, autostart=False)
    with pytest.raises(ValueError, match="paged=False"):
        ServingEngine(model, device="cpu", paged=False, max_pages=4, autostart=False)
    with pytest.raises(TypeError, match="LlamaForCausalLM"):
        ServingEngine(torch.nn.Linear(2, 2), device="cpu", autostart=False)
    idle = ServingEngine(model, device="cpu", autostart=False)
    with pytest.raises(RuntimeError, match="not accepting"):
        idle.submit([[1]])
    idle.shutdown()
    engine = make_engine(model, max_slots=2, max_len=64, prefill_chunk=8, max_pages=4)
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(np.ones((1, 60), np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="KV pages"):
        engine.submit(np.ones((1, 30), np.int32), max_new_tokens=10)  # 5 pages > 4
    with pytest.raises(TypeError, match="seed"):
        engine.submit([[1]], seed=1.5)
    req = engine.submit([[1, 2]], max_new_tokens=2)
    req.result(WAIT)
    with pytest.raises(ValueError, match="single-use"):
        engine.submit(request=req)
