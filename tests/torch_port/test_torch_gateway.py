"""The HTTP gateway in both front ends (``serving/gateway.py``,
``serving/gateway_aio.py``) on the CPU: the same requests to the port's
gateway and to the JAX package's, over real sockets on ``127.0.0.1:0``,
then the port's failover, restart and drain over HTTP.

The JAX gateway is given :class:`~torch_fleet_common.NullCompileWatcher`
before ``start()`` (jax 0.9.0 lacks the hook its own watcher's ``stop``
calls). The one ``/metrics`` family pair the port renames is
``accelerate_tpu_xla_compile_{events,seconds}_total`` →
``accelerate_tpu_graph_capture_{events,seconds}_total``."""

import threading

import pytest

from accelerate_tpu.adapters import AdapterBank as JaxAdapterBank
from accelerate_tpu.adapters import LoRAConfig as JaxLoRAConfig
from accelerate_tpu.serving import ChaosSchedule as JaxChaosSchedule
from accelerate_tpu.serving import GatewayConfig as JaxGatewayConfig
from accelerate_tpu.serving import ReplicaSet as JaxReplicaSet
from accelerate_tpu.serving import ServingGateway as JaxServingGateway
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.adapters import AdapterBank, LoRAConfig
from accelerate_tpu_torch.observability import Tracer, lint_prometheus_text
from accelerate_tpu_torch.serving import (
    ChaosSchedule,
    FleetSupervisor,
    GatewayConfig,
    ReplicaSet,
    ReplicaState,
    ServingGateway,
)
from accelerate_tpu_torch.utils.dataclasses import ProfileKwargs

from torch_fleet_common import (
    NullCompileWatcher,
    families,
    get,
    jax_engine,
    port_engine,
    post,
    samples,
    sse_events,
    wait_for,
)
from torch_serving_common import WAIT, Oracle, pair, prompts

ENGINE = dict(max_slots=2, max_len=64, prefill_chunk=16)
SERVERS = ["asyncio", "threading"]
RENAMED = {"accelerate_tpu_graph_capture_events_total": "accelerate_tpu_xla_compile_events_total",
           "accelerate_tpu_graph_capture_seconds_total": "accelerate_tpu_xla_compile_seconds_total"}


@pytest.fixture(scope="module")
def tiny():
    module, params, model = pair()
    return module, params, model, Oracle(module, params)


def exchange(gw, gateway_stats, work):
    """One fixed conversation with a started gateway; every answer reduced
    to what both packages must agree on."""
    url = gw.url
    out = []
    p0, p1 = (w.ravel().tolist() for w in work)
    code, body, hdr = post(url, {"prompt": p0, "max_new_tokens": 6})
    out.append(("json", code, sorted(body), body["tokens"], body["failovers"],
                hdr.get("X-Request-Id") == body["trace_id"]))
    trace_id = body["trace_id"]
    code, text, hdr = post(url, {"prompt": [p1], "max_new_tokens": 5, "stream": True})
    events = sse_events(text)
    out.append(("sse", code, hdr.get("Content-Type"), text.count("\n\n"),
                [sorted(e) for e in events], [e["token"] for e in events[:-1]],
                events[-1]["tokens"], events[-1]["status"]))
    for name, payload, raw in (("no prompt", {"max_new_tokens": 3}, None),
                               ("bad json", None, b"{"),
                               ("bad max_new", {"prompt": p0, "max_new_tokens": 0}, None),
                               ("too big", None, b"x" * 5000)):
        code, body, _ = post(url, payload, raw=raw)
        out.append((name, code, sorted(body)))
    code, body, _ = post(url, {"prompt": p0, "adapter": "ghost"})
    out.append(("unknown adapter", code, body["error"]))
    for _ in range(2):  # the tenant's bucket holds one request
        code, body, hdr = post(url, {"prompt": p0, "adapter": "lim"})
        out.append(("rate limit", code, body["error"], hdr.get("Retry-After")))
    code, body, _ = post(url, {"prompt": p0}, path="/v1/nothing")
    out.append(("post 404", code, body))
    for path in ("/healthz", "/readyz", "/nothing", f"/debug/trace?id={trace_id}",
                 "/debug/trace?id=not%20an%20id", "/debug/trace?id=0123456789abcdef"):
        code, text, _ = get(url, path)
        out.append((path.split("=")[0], code, text if path in ("/healthz", "/readyz") else None))
    # Drain: a long stream in flight keeps streaming to its end, while
    # readiness and new completions answer 503 with Retry-After.
    result = {}

    def stream():
        result["r"] = post(url, {"prompt": p0, "max_new_tokens": 40, "stream": True})

    t = threading.Thread(target=stream)
    t.start()
    wait_for(lambda: gateway_stats.summary()["open_sse_streams"] == 1, what="the stream")
    gw.drain()
    code, text, hdr = get(url, "/readyz")
    out.append(("drain readyz", code, text, hdr.get("Retry-After")))
    code, body, hdr = post(url, {"prompt": p0, "max_new_tokens": 2})
    out.append(("drain post", code, body["error"], hdr.get("Retry-After")))
    t.join(WAIT)
    code, text, _ = result["r"]
    events = sse_events(text)
    out.append(("drained stream", code, len(events), events[-1]["status"]))
    code, metrics, hdr = get(url, "/metrics")
    return out, metrics, hdr


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("server", SERVERS)
def test_the_gateways_answer_alike(tiny, server):
    """Status codes (200, 400, 404, 413, 429 and 503 with Retry-After), JSON
    keys, SSE framing, greedy token ids, drain, and a ``/metrics`` body that
    passes promlint with the JAX gateway's families."""
    module, params, model, oracle = tiny
    work = prompts((7, 12), seed=31)
    cfg = dict(server=server, port=0, rate_limits={"lim": 0.001}, max_body_bytes=4096)
    slow = dict(from_tick=0, until_tick=10_000, delay_s=0.01)

    jax_fleet = JaxReplicaSet([jax_engine(
        module, params, chaos=JaxChaosSchedule().slow(**slow),
        adapters=JaxAdapterBank(params, config=JaxLoRAConfig(rank=2), max_adapters=2),
        **ENGINE)])
    jax_gw = JaxServingGateway(jax_fleet, config=JaxGatewayConfig(**cfg))
    jax_gw.compile_watcher = NullCompileWatcher()
    jax_gw.start()
    try:
        jax_out, jax_metrics, _ = exchange(jax_gw, jax_gw.stats, work)
    finally:
        jax_gw.shutdown(drain=False, timeout=WAIT)

    fleet = ReplicaSet([port_engine(
        model, chaos=ChaosSchedule().slow(**slow),
        adapters=AdapterBank(model, config=LoRAConfig(rank=2), max_adapters=2), **ENGINE)])
    gw = ServingGateway(fleet, config=GatewayConfig(**cfg))
    gw.start()
    try:
        port_out, metrics, hdr = exchange(gw, gw.stats, work)
    finally:
        gw.shutdown(drain=False, timeout=WAIT)

    assert port_out == jax_out
    codes = [entry[1] for entry in port_out]
    assert codes == [200, 200, 400, 400, 400, 413, 404, 404, 429, 404, 200, 200, 404, 200,
                     400, 404, 503, 503, 200]
    assert port_out[0][3] == oracle(work[0], 6).tolist()
    assert port_out[1][5] == oracle(work[1], 5).tolist()
    assert port_out[8][3] == "60"  # the bucket's refill, clamped to retry_after_max_s
    assert port_out[-1][2] == 41  # 40 tokens and the summary: the drain let it finish
    assert "version=0.0.4" in hdr["Content-Type"]
    assert lint_prometheus_text(metrics) == []
    port_families = {RENAMED.get(f, f) for f in families(metrics)}
    # The port's engine summary has one key the JAX one lacks
    # (``pages_used_max``, held by test_torch_serving_scheduler.py).
    assert port_families - families(jax_metrics) == {"accelerate_tpu_serving_pages_used_max"}
    assert families(jax_metrics) <= port_families
    assert "accelerate_tpu_xla_compilation_cache_hits_total" in port_families


@pytest.mark.parametrize("server", SERVERS)
def test_failover_restart_over_http(tiny, server):
    """A kill mid-stream under the gateway and a supervisor: every JSON and
    SSE completion is token-exact, failovers are reported, replica 0 heals,
    and ``/metrics`` counts the restart and the rebuilt engine's captures."""
    _, _, model, oracle = tiny

    def make(chaos=None):
        return port_engine(model, chaos=chaos, **ENGINE)

    fleet = ReplicaSet([make(ChaosSchedule().kill(at_tick=4)), make()], factories=[make, make])
    work = prompts((5, 9, 14, 3, 20, 8), seed=32)
    results = [None] * len(work)
    with FleetSupervisor(fleet, poll_interval_s=0.02, restart_backoff_s=0.01), \
            ServingGateway(fleet, config=GatewayConfig(server=server, port=0)) as gw:
        _, before, _ = get(gw.url, "/metrics")

        def call(i):
            results[i] = post(gw.url, {"prompt": work[i].ravel().tolist(), "max_new_tokens": 10,
                                       "stream": i % 2 == 1})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        failovers = 0
        for i, (code, body, _) in enumerate(results):
            assert code == 200
            final = sse_events(body)[-1] if i % 2 else body
            assert final["status"] == "completed"
            assert final["tokens"] == oracle(work[i], 10).tolist()
            if i % 2:
                assert [e["token"] for e in sse_events(body)[:-1]] == final["tokens"]
            failovers += final["failovers"]
        assert failovers >= 1
        wait_for(lambda: fleet.replica_states()[0] is ReplicaState.HEALTHY, what="the restart")
        code, text, _ = get(gw.url, "/metrics")
    assert lint_prometheus_text(text) == []
    now, then = samples(text), samples(before)
    assert now["accelerate_tpu_serving_fleet_restarts"] == 1
    assert now["accelerate_tpu_serving_fleet_failovers"] == failovers
    assert then["accelerate_tpu_graph_capture_events_total"] == 0
    assert now["accelerate_tpu_graph_capture_events_total"] > 0  # the rebuilt engine's warmup
    assert now["accelerate_tpu_gateway_http_2xx"] >= len(work)


def test_gateway_counters_reach_the_accelerator_and_its_profile(tiny, tmp_path):
    """``ServingGateway(accelerator=...)`` records into the accelerator's
    ``gateway_stats``; a profile session snapshots them under ``gateway/``
    and, with a tracer attached, emits one ``train_step`` span a step."""
    _, _, model, _ = tiny
    acc = Accelerator(cpu=True)
    fleet = ReplicaSet([port_engine(model, **ENGINE)])
    with ServingGateway(fleet, config=GatewayConfig(port=0), accelerator=acc) as gw:
        assert gw.stats is acc.gateway_stats
        assert post(gw.url, {"prompt": [1, 2, 3], "max_new_tokens": 2})[0] == 200
    assert acc.gateway_metrics()["http_2xx"] == 1
    logged = []

    class Sink:
        name = "sink"

        def log(self, values, step=None, **kwargs):
            logged.append(values)

    acc.trackers = [Sink()]
    acc.log({"loss": 1.0}, include_gateway=True)
    assert logged[0]["gateway/http_2xx"] == 1 and logged[0]["loss"] == 1.0
    tracer = Tracer(name="train")
    with acc.profile(ProfileKwargs(output_trace_dir=str(tmp_path))) as prof:
        prof.attach_tracer(tracer)
        for _ in range(2):
            prof.step()
    assert prof.step_breakdowns[-1]["gateway/http_2xx"] == 1
    assert prof.gateway_breakdown()["http_requests"] == 1
    spans = [e for e in tracer.events() if e[3] == "train_step"]
    assert [s[6]["step"] for s in spans] == [0, 1]


def test_signal_handlers_need_the_main_thread(tiny):
    _, _, model, _ = tiny
    gw = ServingGateway(port_engine(model, **ENGINE), config=GatewayConfig(port=0))
    result = {}
    t = threading.Thread(target=lambda: result.update(ok=gw.install_signal_handlers()))
    t.start()
    t.join(WAIT)
    assert result == {"ok": False}
    gw.shutdown(drain=False, timeout=WAIT)
    with pytest.raises(TypeError):
        ServingGateway("not a fleet")
    with pytest.raises(ValueError):
        GatewayConfig(server="twisted")
