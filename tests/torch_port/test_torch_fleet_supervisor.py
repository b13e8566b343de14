"""The fleet supervisor and scripted faults (``serving/supervisor.py``,
``serving/chaos.py``, the engine's chaos hooks) on the CPU, held against
the JAX package's under the same schedules. Timing comes from
``ChaosSchedule.slow`` and ``wedge`` on the tiny model, never from
wall-clock ratios."""

import time

import pytest

from accelerate_tpu.serving import ChaosSchedule as JaxChaosSchedule
from accelerate_tpu.serving import FleetSupervisor as JaxFleetSupervisor
from accelerate_tpu.serving import ReplicaSet as JaxReplicaSet
from accelerate_tpu.serving import ReplicaState as JaxReplicaState
from accelerate_tpu_torch.serving import (
    ChaosSchedule,
    FleetSupervisor,
    HungReplicaError,
    ReplicaSet,
    ReplicaState,
    RequestStatus,
)

from torch_fleet_common import jax_engine, port_engine, wait_for
from torch_serving_common import WAIT, Oracle, pair, prompts

ENGINE = dict(max_slots=2, max_len=64, prefill_chunk=16)


@pytest.fixture(scope="module")
def tiny():
    module, params, model = pair()
    return module, params, model, Oracle(module, params)


def builders(tiny):
    """``{package: (make(chaos=None), ReplicaSet, FleetSupervisor,
    ReplicaState, ChaosSchedule)}``."""
    module, params, model, _ = tiny
    return {
        "jax": (lambda chaos=None: jax_engine(module, params, chaos=chaos, **ENGINE),
                JaxReplicaSet, JaxFleetSupervisor, JaxReplicaState, JaxChaosSchedule),
        "port": (lambda chaos=None: port_engine(model, chaos=chaos, **ENGINE),
                 ReplicaSet, FleetSupervisor, ReplicaState, ChaosSchedule),
    }


def hang_drill(make, RS, Sup, State, Chaos, work):
    """Replica 0 ticks slowly, then freezes its heartbeat: the watchdog
    fences it, its streams resume on replica 1, the supervisor rebuilds
    it. Returns the streams, the event kinds and the fleet metrics."""
    chaos = Chaos().slow(from_tick=0, until_tick=10_000, delay_s=0.03).hang(at_tick=3)
    fleet = RS([make(chaos), make()], factories=[make, make])
    try:
        with Sup(fleet, hang_timeout_s=0.3, poll_interval_s=0.02, restart_backoff_s=0.01,
                 kill_grace_s=2.0) as sup:
            reqs = [fleet.submit(p, max_new_tokens=n) for p, n in work]
            streams = [r.result(WAIT).tolist() for r in reqs]
            wait_for(lambda: fleet.replica_states()[0] is State.HEALTHY
                     and fleet.fleet_metrics()["fleet_restarts"] == 1, what="the restart")
            kinds = [e["kind"] for e in sup.events()]
            metrics = fleet.fleet_metrics()
            reports = fleet.failover_reports
        assert chaos.fired() == ["slow", "hang"]
        return streams, [r.replica_trail for r in reqs], kinds, metrics, reports
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_hang_is_fenced_and_restarted_like_the_jax_supervisor(tiny):
    """A chaos hang: fence, failover, restart, the same supervisor events
    in the same order as the JAX supervisor's, streams token-exact."""
    oracle = tiny[3]
    work = [(p, 32) for p in prompts((5, 12, 7), seed=21)]
    out = {name: hang_drill(*b, work) for name, b in builders(tiny).items()}
    (streams, trails, kinds, metrics, reports), jax_out = out["port"], out["jax"]
    for (prompt, n), got in zip(work, streams):
        assert got == oracle(prompt, n).tolist()
    assert streams == jax_out[0]
    assert kinds == jax_out[2] == ["hang_fence", "restart"]
    assert any(len(t) == 2 for t in trails)  # a stream was live on the hung replica
    for key in ("fleet_hang_fences", "fleet_fences", "fleet_restarts", "replicas_healthy"):
        assert metrics[key] == jax_out[3][key], key
    assert metrics["fleet_hang_fences"] == 1
    assert any("HungReplicaError" in rep["error"] for rep in reports)


def breaker_drill(make, RS, Sup, State, Chaos):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] > 1:  # the first call builds the fleet; rebuilds fail
            raise RuntimeError(f"factory boom #{calls['n']}")
        return make()

    fleet = RS.from_factory(flaky, 1)
    sup = Sup(fleet, restart_backoff_s=0.001, restart_backoff_max_s=0.002, max_restarts=2,
              restart_window_s=60.0)
    try:
        fleet.kill_replica(0, RuntimeError("die"))
        wait_for(lambda: fleet.replicas[0].engine.error is not None, what="the death")
        deadline = time.monotonic() + WAIT
        while fleet.replica_states()[0] is not State.CRASH_LOOP:
            assert time.monotonic() < deadline, "the breaker never tripped"
            sup.check_once()
            time.sleep(0.005)
        attempts = calls["n"]
        sup.check_once()
        fleet.refresh_health()
        sup.check_once()
        assert calls["n"] == attempts  # an open breaker attempts nothing
        assert not fleet.ready
        metrics = fleet.fleet_metrics()
        fleet.reset_circuit(0)
        reset = fleet.replica_states()[0]
        return ([e["kind"] for e in sup.events()], sup.restarts_failed, sup.breaker_trips,
                metrics["replicas_crash_loop"], reset is State.FAILED)
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_circuit_breaker_trips_after_the_same_failed_restarts_as_jax(tiny):
    out = {name: breaker_drill(*b) for name, b in builders(tiny).items()}
    assert out["port"] == out["jax"]
    assert out["port"] == (["restart_failed", "restart_failed", "circuit_open"], 2, 1, 1, True)


def test_wedge_is_fenced_force_retired_and_the_thread_abandoned(tiny):
    """A wedge stops the loop inside a launched tick's reconcile: no
    heartbeat, no commit. The watchdog fences within its timeout, the kill
    cannot land, so the supervisor retires the requests itself; they finish
    on the survivor token-exact, and the rebuilt replica serves."""
    _, _, model, oracle = tiny

    def make(chaos=None):
        return port_engine(model, chaos=chaos, **ENGINE)

    chaos = ChaosSchedule().wedge(at_tick=3, duration_s=2.0)
    fleet = ReplicaSet([make(chaos), make()], factories=[make, make])
    work = [(p, 12) for p in prompts((6, 10), seed=22)]
    try:
        with FleetSupervisor(fleet, hang_timeout_s=0.3, poll_interval_s=0.02,
                             kill_grace_s=0.2, restart_backoff_s=0.01) as sup:
            reqs = [fleet.submit(p, max_new_tokens=n) for p, n in work]
            wait_for(lambda: sup.hang_fences == 1, what="the hang fence")
            for (prompt, n), r in zip(work, reqs):
                assert r.result(WAIT).tolist() == oracle(prompt, n).tolist()
            assert reqs[0].replica_trail == [0, 1]
            wait_for(lambda: fleet.replica_states()[0] is ReplicaState.HEALTHY,
                     what="the restart")
            # A force-retire means the kill found the loop still wedged: the
            # fence came from the stalled heartbeat, not the wedge's end.
            kinds = [e["kind"] for e in sup.events()]
            assert kinds[:2] == ["hang_fence", "force_retire"] and "restart" in kinds
            assert sup.force_retired >= 1
            assert any("HungReplicaError" in rep["error"] for rep in fleet.failover_reports)
            assert fleet.submit(work[0][0], max_new_tokens=12).result(WAIT).tolist() \
                == reqs[0].result(WAIT).tolist()
        assert chaos.fired() == ["wedge"]
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


def test_hang_freezes_the_heartbeat_while_ticks_go_on(tiny):
    """A hang stops the published heartbeat and nothing else; when its
    duration ends the heartbeat moves again."""
    _, _, model, oracle = tiny
    chaos = ChaosSchedule().slow(from_tick=0, until_tick=10_000, delay_s=0.01) \
        .hang(at_tick=2, duration_s=1.0)
    engine = port_engine(model, chaos=chaos, **ENGINE)
    try:
        prompt = prompts((5,), seed=23)[0]
        req = engine.submit(prompt, max_new_tokens=40)
        wait_for(lambda: engine._heartbeat_frozen, what="the hang")
        frozen, ticks = engine.heartbeat, engine.decode_ticks
        time.sleep(0.15)
        assert engine.heartbeat == frozen and engine.decode_ticks > ticks
        assert req.result(WAIT).tolist() == oracle(prompt, 40).tolist()
        wait_for(lambda: engine.heartbeat != frozen, what="the heartbeat")
        kinds = [e["kind"] for e in engine.flight_recorder.snapshot()]
        assert kinds.index("chaos_hang") < kinds.index("chaos_hang_end")
    finally:
        engine.shutdown(drain=False, timeout=WAIT)


def test_projected_deficit_and_drain_rate_units(tiny):
    """Pages short for a request behind the queue, and pages freed a
    second once decode ticks have retired streams; a dense engine is never
    short."""
    _, _, model, _ = tiny
    engine = port_engine(model, max_slots=2, max_len=32, prefill_chunk=8, page_size=8)
    try:
        free, page = engine.free_pages, engine.page_size
        assert engine.projected_page_deficit(free * page) == 0
        assert engine.projected_page_deficit((free + 3) * page) == 3
        assert engine.projected_page_deficit(0) == 0
        assert engine.page_drain_rate() == 0.0  # nothing observed yet
        for p in prompts((9, 17, 4), seed=24):
            engine.submit(p, max_new_tokens=6).result(WAIT)
        assert engine.page_drain_rate() > 0.0
    finally:
        engine.shutdown(drain=False, timeout=WAIT)
    dense = port_engine(model, max_slots=1, max_len=16, paged=False)
    try:
        assert dense.projected_page_deficit(10_000) == 0 and dense.page_drain_rate() == 0.0
    finally:
        dense.shutdown(drain=False, timeout=WAIT)


def test_trace_dir_dumps_on_death(tiny, tmp_path):
    """A killed engine writes its spans and flight record to ``trace_dir``
    as it dies, the fatal event last."""
    import json

    _, _, model, _ = tiny
    engine = port_engine(model, trace_dir=str(tmp_path), chaos=ChaosSchedule().kill(at_tick=2),
                         **ENGINE)
    req = engine.submit(prompts((5,), seed=25)[0], max_new_tokens=10)
    assert req.wait(WAIT) and req.status is RequestStatus.FAILED
    name = engine.tracer.name
    flight = json.loads((tmp_path / f"{name}-flight.json").read_text())
    kinds = [e["kind"] for e in flight["events"]]
    assert kinds[-1] == "fatal" and "chaos_kill" in kinds
    assert (tmp_path / f"{name}-trace.json").exists()
    with pytest.raises(RuntimeError, match="died"):
        engine.shutdown(drain=False, timeout=WAIT)


def test_schedule_and_supervisor_validation(tiny):
    with pytest.raises(ValueError):
        ChaosSchedule().slow(from_tick=5, until_tick=5, delay_s=0.1)
    with pytest.raises(ValueError):
        ChaosSchedule().wedge(at_tick=1, duration_s=0)
    assert repr(ChaosSchedule().kill(3)) == "ChaosSchedule(kill@3)"
    _, _, model, _ = tiny
    fleet = ReplicaSet([port_engine(model, **ENGINE)])
    try:
        with pytest.raises(ValueError):
            FleetSupervisor(fleet, hang_timeout_s=0)
        with pytest.raises(ValueError):
            FleetSupervisor(fleet, max_restarts=0)
        assert issubclass(HungReplicaError, RuntimeError)
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)
