"""The fleet's control plane (``accelerate_tpu_torch/serving/control.py``):
token buckets, tenant rate limits, weighted fair share and the autoscaler
make the same decisions as the JAX package's on the same seeded event
sequence, under an injected clock."""

import numpy as np
import pytest
import torch

from accelerate_tpu.serving import control as jax_control
from accelerate_tpu.serving import router as jax_router
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.serving import ReplicaSet, control
from accelerate_tpu_torch.serving import router
from accelerate_tpu_torch.serving.gateway import GatewayConfig, ServingGateway

from torch_fleet_common import port_engine, post
from torch_serving_common import WAIT

PACKAGES = {"jax": (jax_control, jax_router), "port": (control, router)}


class Clock:
    """A stand-in for the ``time`` module of a control module: ``monotonic``
    reads a value the test sets."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


def each_package(monkeypatch, run):
    """``run(control_module, router_module, clock)`` in both packages, each
    control module's clock injected; returns ``{name: result}``."""
    out = {}
    for name, (ctl, rtr) in PACKAGES.items():
        clock = Clock()
        monkeypatch.setattr(ctl, "time", clock)
        out[name] = run(ctl, rtr, clock)
    return out


def test_token_bucket_decisions_match(monkeypatch):
    def run(ctl, _, clock):
        rng = np.random.default_rng(0)
        bucket = ctl.TokenBucket(rate_per_s=3.0, burst=2.5)
        trace = []
        for _ in range(200):
            clock.now += float(rng.exponential(0.25))
            if rng.random() < 0.5:
                trace.append(("acquire", bucket.try_acquire()))
            else:
                trace.append(("retry", bucket.retry_after(clock.now)))
        return trace

    out = each_package(monkeypatch, run)
    assert out["port"] == out["jax"]
    assert {d for kind, d in out["port"] if kind == "acquire"} == {True, False}
    with pytest.raises(ValueError):
        control.TokenBucket(rate_per_s=0.0, burst=1.0)


def test_tenant_rate_limiter_decisions_match(monkeypatch):
    def run(ctl, _, clock):
        rng = np.random.default_rng(1)
        limiter = ctl.TenantRateLimiter({"a": 4.0, "b": 0.5, "*": 1.5}, burst_s=1.5)
        tenants = ["a", "b", "c", "_base", "d"]
        trace = []
        for _ in range(300):
            clock.now += float(rng.exponential(0.1))
            t = tenants[int(rng.integers(len(tenants)))]
            trace.append((t, limiter.admit(t)))
        return trace

    out = each_package(monkeypatch, run)
    assert out["port"] == out["jax"]
    assert any(r is None for _, r in out["port"]) and any(r is not None for _, r in out["port"])
    assert control.TenantRateLimiter({"a": 1.0}).admit("zz") is None  # unlisted, no "*"
    with pytest.raises(ValueError):
        control.TenantRateLimiter({"a": -1.0})


def test_fair_share_decisions_match():
    def run(ctl):
        rng = np.random.default_rng(2)
        fs = ctl.FairShareAdmission({"gold": 3.0, "silver": 1.0, "*": 0.5}, pressure=0.6)
        held, trace = [], []
        tenants = ["gold", "silver", "bronze", "_base"]
        for _ in range(400):
            if held and rng.random() < 0.45:
                t = held.pop(int(rng.integers(len(held))))
                fs.release(t)
                trace.append(("release", t))
            else:
                t = tenants[int(rng.integers(len(tenants)))]
                cap = int(rng.integers(4, 12))
                ok = fs.try_acquire(t, cap)
                if ok:
                    held.append(t)
                trace.append((t, cap, ok, fs.guaranteed(t, cap), fs.inflight()))
        return trace, fs.sheds

    port, jax = run(control), run(jax_control)
    assert port == jax
    assert port[1] > 0  # some over-share tenant was shed under pressure


class FakeEngine:
    def __init__(self, max_slots=4):
        self.max_slots = max_slots
        self.free_slots = max_slots
        self._queue = []
        self.deficit = 0
        self.healthy = True

    def projected_page_deficit(self, total_tokens):
        return self.deficit


class FakeReplica:
    def __init__(self, index, state, engine):
        self.index, self.state, self.engine = index, state, engine


class FakeFleet:
    """Duck-types the parts of a ``ReplicaSet`` the autoscaler drives, in
    one package's ``ReplicaState``."""

    def __init__(self, State, running, parked):
        self.State = State
        self.replicas = ([FakeReplica(i, State.HEALTHY, FakeEngine()) for i in range(running)]
                         + [FakeReplica(i, State.PARKED, None)
                            for i in range(running, running + parked)])
        self.rate = 0.0
        self.log = []

    def __len__(self):
        return len(self.replicas)

    def page_drain_rate(self):
        return self.rate

    def drain_replica(self, i):
        self.replicas[i].state = self.State.DRAINING
        self.log.append(("drain", i))

    def park_replica(self, i):
        self.replicas[i].state = self.State.PARKED
        self.replicas[i].engine = None
        self.log.append(("park", i))

    def unpark_replica(self, i):
        self.replicas[i].state = self.State.HEALTHY
        self.replicas[i].engine = FakeEngine()
        self.log.append(("unpark", i))


def test_autoscaler_steps_match(monkeypatch):
    """Seeded queue depth, busy slots, page deficit and drain rate over
    time: the same scale-ups, drains and parks, in the same order, with the
    same flight events."""

    def run(ctl, rtr, clock):
        rng = np.random.default_rng(3)
        fleet = FakeFleet(rtr.ReplicaState, running=1, parked=2)
        scaler = ctl.FleetAutoscaler(fleet, ctl.AutoscaleConfig(
            min_replicas=1, max_replicas=3, scale_up_queue_depth=3.0, scale_up_wait_s=2.0,
            scale_down_idle_s=1.0, idle_load=0.25, cooldown_s=0.5))
        now, actions = 0.0, []
        for step in range(300):
            now += float(rng.uniform(0.05, 0.3))
            phase = (step // 60) % 2  # bursts, then quiet
            fleet.rate = float(rng.uniform(0.0, 4.0))
            for r in fleet.replicas:
                if r.engine is None:
                    continue
                busy = int(rng.integers(0, 5)) if phase == 0 else int(rng.integers(0, 2))
                r.engine.free_slots = r.engine.max_slots - busy
                r.engine._queue = [0] * (int(rng.integers(0, 8)) if phase == 0 else 0)
                r.engine.deficit = int(rng.integers(0, 12)) if phase == 0 else 0
            actions.append(scaler.step(now))
        return (actions, fleet.log, [e["kind"] for e in scaler.events()],
                scaler.scale_ups, scaler.scale_downs)

    out = each_package(monkeypatch, run)
    assert out["port"] == out["jax"]
    actions = out["port"][0]
    assert {"up", "down", "parked"} <= set(actions)


def test_autoscale_config_validation():
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(scale_up_queue_depth=0), dict(cooldown_s=-1), dict(idle_load=1.0)):
        with pytest.raises(ValueError):
            control.AutoscaleConfig(**bad)
    with pytest.raises(ValueError, match="max_replicas"):
        control.FleetAutoscaler(FakeFleet(router.ReplicaState, 1, 0),
                                control.AutoscaleConfig(max_replicas=2))


def test_gateway_fair_share_slot_returns_when_the_stream_ends():
    """A completion admitted under fair share gives its tenant's slot back
    when it finishes; the gateway's rate limiter is built from its config."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    fleet = ReplicaSet([port_engine(model, max_slots=2, max_len=64, prefill_chunk=16)])
    cfg = GatewayConfig(port=0, fair_share_weights={"*": 1.0}, rate_limits={"*": 100.0})
    with ServingGateway(fleet, config=cfg) as gw:
        assert isinstance(gw.fair_share, control.FairShareAdmission)
        assert isinstance(gw.rate_limiter, control.TenantRateLimiter)
        code, body, _ = post(gw.url, {"prompt": [1, 2, 3], "max_new_tokens": 4}, timeout=WAIT)
        assert code == 200 and len(body["tokens"]) == 4
        assert gw.fair_share.inflight() == 0
