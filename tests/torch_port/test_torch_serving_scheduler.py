"""The serving engine's host-side pieces against the JAX package's: the
same scenario through the JAX class and the port's class must give the
same observable results (``AdmissionQueue`` FIFO, priority and
backpressure, ``SlotScheduler``, ``PagePool`` refcounts, ``PrefixCache``
LRU, ``Request`` semantics, ``ServingStats`` keys, ``PriorityPolicy``,
the tracer and flight recorder), plus ``GraphCaptureWatcher`` and the
graph runner's CPU path."""

import threading
import time

import numpy as np
import pytest
import torch

import accelerate_tpu.observability as jax_obs
import accelerate_tpu.serving as jax_serving
import accelerate_tpu_torch.observability as port_obs
import accelerate_tpu_torch.serving as port_serving
from accelerate_tpu_torch.utils.profiling import GraphCaptureWatcher

SIDES = {"jax": jax_serving, "port": port_serving}


def both(scenario):
    """Run ``scenario(module)`` on each side; return the two results."""
    return scenario(jax_serving), scenario(port_serving)


def test_admission_queue_fifo_and_backpressure():
    def scenario(m):
        q = m.AdmissionQueue(max_queued=2, rank_fn=None)
        a, b = m.Request([[1]]), m.Request([[2, 3]], max_new_tokens=4)
        q.put(a, block=False)
        q.put(b, block=False)
        out = [len(q), q.pending_tokens]
        for block in (False, True):
            try:
                q.put(m.Request([[3]]), block=block, timeout=0.01)
            except m.QueueFull:
                out.append("full")
        out.append(q.get_nowait() is a)
        q.putleft(a)
        out.append([r is x for r, x in zip(q.drain(), (a, b))])
        q.close()
        try:
            q.put(m.Request([[4]]), block=False)
        except m.QueueClosed:
            out.append("closed")
        return out

    jax_out, port_out = both(scenario)
    assert jax_out == port_out == [2, 1 + 20 + 2 + 4, "full", "full", True, [True, True],
                                   "closed"]


def test_admission_queue_priority_classes():
    def scenario(m):
        policy = m.PriorityPolicy()
        q = m.AdmissionQueue(max_queued=8, rank_fn=policy.rank)
        order = ["batch", None, "interactive", "standard", "interactive", "unknown"]
        reqs = [m.Request([[i + 1]], priority=p) for i, p in enumerate(order)]
        for r in reqs:
            q.put(r, block=False)
        return [reqs.index(q.get_nowait()) for _ in reqs], policy.rank("nope"), repr(policy)

    jax_out, port_out = both(scenario)
    assert jax_out == port_out
    assert jax_out[0] == [2, 4, 1, 3, 5, 0]  # strict class order, FIFO within a class


def test_blocked_put_wakes_on_space_and_on_close():
    for m in SIDES.values():
        q = m.AdmissionQueue(max_queued=1)
        q.put(m.Request([[1]]), block=False)
        results = []

        def producer():
            try:
                q.put(m.Request([[2]]), block=True, timeout=30)
                results.append("put")
            except m.QueueClosed:
                results.append("closed")

        t = threading.Thread(target=producer)
        t.start()
        time.sleep(0.02)
        q.get_nowait()  # space: the blocked put goes through
        t.join(10)
        assert not t.is_alive() and results == ["put"]
        t = threading.Thread(target=producer)
        t.start()
        time.sleep(0.02)
        q.close()  # the engine stopped: the blocked put is woken with QueueClosed
        t.join(10)
        assert not t.is_alive() and results == ["put", "closed"]


def test_slot_scheduler_free_list():
    def scenario(m):
        s = m.SlotScheduler(2)
        r0, r1, r2 = m.Request([[1]]), m.Request([[2]]), m.Request([[3]])
        out = [s.assign(r0), s.assign(r1), s.has_free(), s.release(0) is r0, r0.slot]
        out += [s.assign(r2), s.occupant(0) is r2, s.active_slots, s.free_slots]
        return out

    jax_out, port_out = both(scenario)
    assert jax_out == port_out == [0, 1, False, True, None, 0, True, 2, 0]


def test_page_pool_refcounts():
    def scenario(m):
        pool = m.scheduler.PagePool(3)
        pages = [pool.alloc() for _ in range(4)]  # the fourth finds the pool dry
        pool.incref(pages[0])
        out = [pages, pool.free_pages, pool.used_pages, pool.decref(pages[0]),
               pool.refcount(pages[0]), pool.decref(pages[0]), pool.free_pages,
               pool.alloc(), pool.allocations, pool.frees]
        for bad in (0, pages[0]):  # the scratch page, and a page already freed
            try:
                pool.decref(bad)
            except ValueError:
                out.append("refused")
        return out

    jax_out, port_out = both(scenario)
    assert jax_out == port_out
    assert jax_out[:3] == [[1, 2, 3, None], 0, 3]


def test_prefix_cache_lru_and_eviction_hook():
    def scenario(m):
        evicted = []
        pc = m.PrefixCache(100, on_evict=lambda k, v: evicted.append(k))
        out = [pc.put(b"a", "A", 40), pc.put(b"b", "B", 40), pc.match([b"a", b"b"]),
               pc.match([b"a", b"x", b"b"])]
        out += [pc.put(b"c", "C", 40), pc.match([b"b"]), list(evicted), len(pc), pc.nbytes]
        out += [pc.put(b"huge", "H", 1000), pc.oversize_rejects, pc.put(b"a", "A2", 40),
                pc.match([b"a"]), pc.longest_prefix([b"c", b"a", b"z"]), pc.evict_lru(),
                [k for k, _ in pc.entries()]]
        pc.clear()
        out += [len(pc), pc.nbytes, sorted(evicted)]
        with pytest.raises(ValueError, match="capacity_bytes"):
            m.PrefixCache(0)
        return out

    jax_out, port_out = both(scenario)
    assert jax_out == port_out
    assert jax_out[6] == [b"b"]  # the least recently used entry went first


def test_request_semantics():
    def scenario(m):
        out = []
        for bad in (dict(prompt_ids=[[1]], max_new_tokens=0),
                    dict(prompt_ids=np.zeros((2, 3), np.int32))):
            try:
                m.Request(**bad)
            except ValueError:
                out.append("refused")
        r = m.Request([[1]])
        try:
            r.result(timeout=0.01)
        except TimeoutError:
            out.append("timeout")
        r._finish(m.RequestStatus.CANCELLED)
        try:
            r.result()
        except RuntimeError as e:
            out.append(str(e))
        r2 = m.Request([1, 2])
        r2.tokens.extend([4, 5])
        r2._finish(m.RequestStatus.COMPLETED)
        r2._finish(m.RequestStatus.FAILED, RuntimeError("late"))  # the first wins
        out += [r2.status.value, r2.result().tolist(), r2.output_ids().tolist(), repr(r2)]
        return out

    jax_out, port_out = both(scenario)
    assert jax_out == port_out


def test_serving_stats_keys_and_values():
    def scenario(m):
        st = m.ServingStats()
        st.record_submit(queue_depth=3)
        st.record_admit(queue_wait_ms=4.0, ttft_ms=10.0)
        st.record_tick(active_slots=2, committed_tokens=2, max_slots=4, seconds=0.01,
                       host_us=50.0)
        st.record_prefill_chunk(5.0, backlog=1)
        st.record_prefix(looked_up=2, hit=1, bytes_restored=128, aliased=1)
        st.record_pages(free=3, used=5, total=8, freed_total=2)
        st.record_finish(m.RequestStatus.COMPLETED)
        return st.summary(), {k: v["count"] for k, v in st.histograms().items()}

    (jax_sum, jax_hist), (port_sum, port_hist) = both(scenario)
    # The port reports every JAX key with the same value, and one more: the
    # peak of pages in use.
    assert set(port_sum) - set(jax_sum) == {"pages_used_max"}
    assert {k: port_sum[k] for k in jax_sum} == jax_sum
    assert port_sum["pages_used_max"] == 5 and port_hist == jax_hist
    merged = port_serving.ServingStats().merge(port_serving.ServingStats())
    assert merged.summary()["requests_submitted"] == 0


def test_tracer_and_flight_recorder():
    def scenario(obs):
        tracer = obs.Tracer(capacity=8, name="t")
        flight = obs.FlightRecorder(capacity=2, name="f", tracer=tracer)
        tracer.emit("span", 1.0, 0.5, trace_id="abc", args={"k": 1})
        tracer.instant("mark", trace_id="abc")
        for kind in ("a", "b", "c"):
            flight.record(kind, trace_id="abc")
        trace = tracer.chrome_trace("abc")
        return ([e[3] for e in tracer.events("abc")], [e["kind"] for e in flight.snapshot()],
                flight.dump()["dropped"], len(trace["traceEvents"]),
                obs.validate_chrome_trace(trace), obs.clean_trace_id("ok-1"),
                obs.clean_trace_id("bad id!"), len(obs.new_trace_id()))

    assert scenario(jax_obs) == scenario(port_obs)


def test_graph_capture_watcher():
    events = []
    w = GraphCaptureWatcher(on_event=lambda name, s: events.append((name, s)))
    assert w.record("decode", ("decode", ("active", (4,))))
    assert not w.record("decode", ("decode", ("active", (4,))))
    assert w.record("chunk", ("chunk", ("ids", (16,))), seconds=0.25)
    assert w.events == ["decode", "chunk"] and w.total == 2
    assert w.summary() == {"graph_captures": 2, "capture_secs": 0.25, "step_signatures": 2}
    w.reset()
    assert w.events == [] and w.counts() == {"decode": 1, "chunk": 1}
    assert w.record("decode", ("decode", ("active", (5,))))  # a new shape is an event
    assert w.events == ["decode"] and w.counts() == {"decode": 2, "chunk": 1}
    assert events == [("decode", None), ("chunk", 0.25), ("decode", None)]


def test_step_graphs_run_eagerly_on_the_cpu():
    w = GraphCaptureWatcher()
    graphs = port_serving.StepGraphs(torch.device("cpu"), w)
    x = torch.zeros(3)
    for _ in range(3):
        graphs.run("inc", lambda: x.add_(1), ("inc", ("x", (3,))))
    assert x.tolist() == [3.0, 3.0, 3.0]
    assert graphs.captured == [] and w.counts() == {"inc": 1}
