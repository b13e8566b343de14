"""The replica router (``accelerate_tpu_torch/serving/router.py``) on the
CPU: two replicas of the tiny Llama at f32, held against the JAX
package's ``ReplicaSet`` under the same scripted kill, and the port's own
guarantees around a restart (monotone counters, the dead engine freed)."""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from accelerate_tpu.serving import ChaosSchedule as JaxChaosSchedule
from accelerate_tpu.serving import ReplicaSet as JaxReplicaSet
from accelerate_tpu_torch.adapters import AdapterBank, LoRAConfig, init_lora_params
from accelerate_tpu_torch.serving import (
    ChaosKilled,
    ChaosSchedule,
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


def port_fleet(model, chaos=None, **kw):
    kw = {**ENGINE, **kw}

    def factory():
        return port_engine(model, **kw)

    first = port_engine(model, chaos=chaos, **kw)
    return ReplicaSet([first, factory()], factories=[factory, factory])


def run(fleet, work):
    reqs = [fleet.submit(p, max_new_tokens=n) for p, n in work]
    return reqs, [r.result(WAIT).tolist() for r in reqs]


class Gate:
    """Parks engine loops at the top of an iteration, where their chaos
    schedule runs, so requests can be routed while no replica admits or
    ticks."""

    def __init__(self):
        self._open = threading.Event()
        self._open.set()
        self._parked = 0
        self._cond = threading.Condition()

    def wait(self):
        if self._open.is_set():
            return
        with self._cond:
            self._parked += 1
            self._cond.notify_all()
        self._open.wait(WAIT)
        with self._cond:
            self._parked -= 1

    def hold(self, loops):
        """Close the gate and wait until ``loops`` engine loops are parked."""
        self._open.clear()
        with self._cond:
            assert self._cond.wait_for(lambda: self._parked == loops, WAIT), "engines parked"

    def release(self):
        self._open.set()


def gated(schedule_cls, gate):
    """A chaos schedule of ``schedule_cls`` whose loop waits at ``gate``."""

    class Gated(schedule_cls):
        def apply(self, engine):
            gate.wait()
            super().apply(engine)

    return Gated()


def run_queued(fleet, work, gate):
    """Route every request while both replicas are parked, then let them
    run: each routing decision sees empty slots and the queues it filled,
    never the engines' progress, so the placement is the same whatever
    the host's speed."""
    gate.hold(len(fleet.replicas))
    try:
        reqs = [fleet.submit(p, max_new_tokens=n) for p, n in work]
    finally:
        gate.release()
    return reqs, [r.result(WAIT).tolist() for r in reqs]


# The JAX engines' threads may warn on the way out of a killed loop; the
# warning says nothing about the port.
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failover_is_token_exact_and_counted_like_the_jax_fleet(tiny):
    """The same kill at decode tick 8 of replica 0 in both packages, every
    stream routed while both replicas are parked and slowed alike: every
    greedy stream is token-exact with JAX ``generate`` and with the JAX
    fleet's, the failed-over ones take the same replica trail, and the
    failover and fence counts and the fleet metric keys agree."""
    module, params, model, oracle = tiny
    work = [(p, 16) for p in prompts((5, 9, 20, 3, 30, 12), seed=3)]
    # One 64-token page a stream: equal load leaves no page tie-break, so
    # the lower index wins every tie. Routed before any admission, the
    # requests alternate 0, 1, 0, ... and the kill at tick 8 lands before
    # any of replica 0's three 16-token streams ends.
    placed = dict(max_slots=3, max_len=64, prefill_chunk=64)
    slow = dict(from_tick=0, until_tick=10_000, delay_s=0.02)

    jgate = Gate()

    def jfactory():
        return jax_engine(module, params, chaos=gated(JaxChaosSchedule, jgate).slow(**slow),
                          **placed)

    jax_fleet = JaxReplicaSet(
        [jax_engine(module, params,
                    chaos=gated(JaxChaosSchedule, jgate).slow(**slow).kill(at_tick=8), **placed),
         jfactory()], factories=[jfactory, jfactory])
    try:
        jreqs, jax_streams = run_queued(jax_fleet, work, jgate)
        jax_metrics = jax_fleet.fleet_metrics()
    finally:
        jax_fleet.shutdown(drain=False, timeout=WAIT)

    gate = Gate()

    def factory():
        return port_engine(model, chaos=gated(ChaosSchedule, gate).slow(**slow), **placed)

    fleet = ReplicaSet(
        [port_engine(model, chaos=gated(ChaosSchedule, gate).slow(**slow).kill(at_tick=8),
                     **placed), factory()], factories=[factory, factory])
    try:
        reqs, streams = run_queued(fleet, work, gate)
        metrics = fleet.fleet_metrics()
        assert fleet.replica_states() == [ReplicaState.FAILED, ReplicaState.HEALTHY]
        assert isinstance(fleet.engine(0).error, ChaosKilled)
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)

    for (prompt, n), got, want in zip(work, streams, jax_streams):
        assert got == want == oracle(prompt, n).tolist()
    assert [r.replica_trail for r in reqs] == [r.replica_trail for r in jreqs]
    assert [r.replica_trail for r in reqs] == [[0, 1], [1], [0, 1], [1], [0, 1], [1]]
    for key in ("fleet_failovers", "fleet_fences", "fleet_submitted", "replicas_failed",
                "replicas_healthy", "fleet_failover_failed"):
        assert metrics[key] == jax_metrics[key], key
    assert metrics["fleet_failovers"] == 3 and metrics["fleet_fences"] == 1
    # The port's engine summary has one key more than the JAX one's
    # (``pages_used_max``, held by test_torch_serving_scheduler.py).
    assert set(metrics) - set(jax_metrics) == {"pages_used_max"}
    assert set(jax_metrics) <= set(metrics)
    report = fleet.failover_reports[0]
    assert report["replica"] == 0 and "ChaosKilled" in report["error"]
    assert report["flight_recorder"]["events"][-1]["kind"] == "fatal"


def test_dead_engine_is_freed_after_a_restart(tiny):
    """Nothing of the router (callbacks, requests, failover reports) keeps a
    killed engine alive once ``restart_replica`` swapped its replacement
    in: its pool and step state return to the allocator."""
    _, _, model, oracle = tiny
    work = [(p, 8) for p in prompts((6, 18, 4), seed=4)]
    fleet = port_fleet(model, chaos=ChaosSchedule().kill(at_tick=3))
    try:
        reqs, streams = run(fleet, work)
        for (prompt, n), got in zip(work, streams):
            assert got == oracle(prompt, n).tolist()
        dead = weakref.ref(fleet.engine(0))
        pool = weakref.ref(fleet.engine(0)._kv[0]["k"])
        fleet.restart_replica(0)
        assert fleet.replica_states()[0] is ReplicaState.HEALTHY
        gc.collect()
        assert dead() is None and pool() is None
        # The replacement serves, and the old requests still read back.
        assert fleet.submit(work[0][0], max_new_tokens=8).result(WAIT).tolist() == streams[0]
        assert [r.result(WAIT).tolist() for r in reqs] == streams
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


def test_seeded_sampled_stream_resumes_with_its_draws(tiny):
    """A draw is keyed by seed and position, so a sampled stream that fails
    over continues with the tokens it would have drawn uninterrupted."""
    _, _, model, _ = tiny
    prompt = prompts((7,), seed=5)[0]
    sampled = dict(do_sample=True, temperature=1.0, top_k=20)
    calm = port_fleet(model, **sampled)
    try:
        want = calm.submit(prompt, max_new_tokens=12, seed=1234).result(WAIT).tolist()
    finally:
        calm.shutdown(drain=False, timeout=WAIT)
    fleet = port_fleet(model, chaos=ChaosSchedule().kill(at_tick=5), **sampled)
    try:
        req = fleet.submit(prompt, max_new_tokens=12, seed=1234)
        assert req.result(WAIT).tolist() == want
        assert req.replica_trail == [0, 1] and req.failovers == 1
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


def test_counters_and_captures_stay_monotone_across_a_restart(tiny):
    """``merged_stats`` keeps the dead engine's counters and
    ``capture_totals`` its step signatures after the swap; a restart's
    warmup adds the new engine's."""
    _, _, model, _ = tiny
    work = [(p, 6) for p in prompts((5, 11, 3, 9), seed=6)]
    fleet = port_fleet(model, chaos=ChaosSchedule().kill(at_tick=3))
    try:
        run(fleet, work)
        before = fleet.merged_stats().summary()
        events, secs = fleet.capture_totals()
        fleet.restart_replica(0)
        after = fleet.merged_stats().summary()
        for key in ("requests_submitted", "requests_completed", "requests_failed",
                    "decode_ticks", "tokens_emitted"):
            assert after[key] == before[key], key
        assert before["requests_failed"] >= 1
        assert before["requests_completed"] == len(work)
        events2, secs2 = fleet.capture_totals()
        assert events2 > events and secs2 >= secs  # the new engine's warmup steps
        assert fleet.fleet_metrics()["fleet_restarts"] == 1
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


def test_restart_and_kill_guards(tiny):
    """Only a fenced replica with a factory restarts; a second kill of a
    fenced replica is a no-op; a tensor-parallel fleet needs its devices."""
    _, _, model, _ = tiny
    lone = ReplicaSet([port_engine(model, **ENGINE)])
    try:
        with pytest.raises(RuntimeError, match="no factory"):
            lone.restart_replica(0)
    finally:
        lone.shutdown(drain=False, timeout=WAIT)
    fleet = port_fleet(model)
    try:
        with pytest.raises(RuntimeError, match="not failed"):
            fleet.restart_replica(0)
        fleet.kill_replica(0)
        wait_for(lambda: fleet.replica_states()[0] is ReplicaState.FAILED, what="the fence")
        fleet.kill_replica(0)  # fenced: the fault is not injected again
        engine = fleet.restart_replica(0)
        assert engine.healthy and engine._fail_injection is None
        assert fleet.fleet_metrics()["fleet_fences"] == 1
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)
    with pytest.raises(ValueError, match="needs at least 2 devices"):
        ReplicaSet.from_mesh(model, tp=2)  # no card here, and no devices= given


def test_cache_aware_and_draining_choice(tiny):
    """A prompt whose prefix one replica holds in its cache goes there; a
    draining replica takes nothing new."""
    _, _, model, oracle = tiny
    fleet = port_fleet(model)
    try:
        base = prompts((40,), seed=7)[0]
        fleet.engine(1).submit(base, max_new_tokens=2).result(WAIT)
        assert fleet.engine(1).cached_prefix_tokens(base) == 32
        follow = np.concatenate([base[:, :36], prompts((5,), seed=8)[0]], axis=1)
        req = fleet.submit(follow, max_new_tokens=4)
        assert req.result(WAIT).tolist() == oracle(follow, 4).tolist()
        assert req.replica_trail == [1]
        fleet.drain_replica(1)
        assert fleet.submit(follow, max_new_tokens=4).replica_trail == [0]
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


def test_chrome_trace_joins_both_replicas_of_a_failed_over_request(tiny):
    """The spans a request left on the dead replica and on the survivor
    carry one trace id and merge into one timeline."""
    _, _, model, _ = tiny
    fleet = port_fleet(model, chaos=ChaosSchedule().kill(at_tick=3))
    try:
        req = fleet.submit(prompts((9,), seed=9)[0], max_new_tokens=10)
        req.result(WAIT)
        assert req.replica_trail == [0, 1]
        trace = fleet.chrome_trace(req.trace_id)
        pids = {e["pid"] for e in trace["traceEvents"] if e.get("ph") != "M"}
        assert len(pids) == 2
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)


def test_adapters_replay_onto_restarted_and_unparked_replicas(tiny):
    """Fleet-wide registrations are recorded: a rebuilt replica's bank and an
    unparked one's know every adapter, and a tenant's stream fails over."""
    _, _, model, _ = tiny
    cfg = LoRAConfig(rank=2)

    def factory():
        return port_engine(model, adapters=AdapterBank(model, config=cfg, max_adapters=3),
                           **ENGINE)

    fleet = ReplicaSet([port_engine(model, chaos=ChaosSchedule().kill(at_tick=3),
                                    adapters=AdapterBank(model, config=cfg, max_adapters=3),
                                    **ENGINE), factory()], factories=[factory, factory])
    try:
        adapter = init_lora_params(torch.Generator().manual_seed(0), model, cfg)
        for mod in adapter.values():
            mod["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        fleet.register_adapter("tenant", adapter)
        req = fleet.submit(prompts((8,), seed=10)[0], max_new_tokens=8, adapter="tenant")
        first = req.result(WAIT).tolist()
        assert req.replica_trail == [0, 1] and req.status is RequestStatus.COMPLETED
        fleet.restart_replica(0)
        assert "tenant" in fleet.engine(0).adapters.names()
        fleet.park_replica(1)
        assert fleet.replica_states()[1] is ReplicaState.PARKED and fleet.engine(1) is None
        again = fleet.submit(prompts((8,), seed=10)[0], max_new_tokens=8, adapter="tenant")
        assert again.result(WAIT).tolist() == first and again.replica_trail == [0]
        fleet.unpark_replica(1)
        assert "tenant" in fleet.engine(1).adapters.names()
        assert fleet.fleet_metrics()["fleet_autoscale_events"] == 2
    finally:
        fleet.shutdown(drain=False, timeout=WAIT)
