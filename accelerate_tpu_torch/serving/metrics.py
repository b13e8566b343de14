"""Serving-engine counters, in the style of ``utils.profiling.PipelineStats``.

Counterpart of ``accelerate_tpu/serving/metrics.py`` (``LatencyHistogram``
``:44``, ``ServingStats`` ``:102``, ``GatewayStats`` ``:574``), with the
same ``summary()`` keys.

The engine is a host loop driving a few fixed-shape steps; the numbers that
matter operationally are therefore host-side:

* per-request **queue wait** (submit -> slot assignment) and **TTFT**
  (submit -> first streamed token, i.e. queue wait + one prefill) — the
  latency a caller actually feels;
* engine-level **decode tokens/sec** (committed tokens over decode-tick
  wall time) — the throughput the fixed-shape batch sustains;
* **slot occupancy** (active slots per tick / ``max_slots``) and **batch
  efficiency** (committed tokens per tick / ``max_slots``) — how much of
  each fixed-shape decode step is doing real work. Low occupancy under
  load means admission is starved (queue too small, prefill too slow);
  occupancy >> efficiency means slots sit done-latched waiting on
  retirement;
* the **chunked-prefill split**: prefill chunk count and milliseconds vs
  decode milliseconds (where the engine's device time actually goes),
  prefill backlog depth (requests sitting in ``PREFILLING``), and the
  prefix-cache hit rate / restored bytes — how much admission work the
  chunk-aligned :class:`scheduler.PrefixCache` is deleting.

Thread-safe: submit() is called from caller threads, everything else from
the engine thread.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Optional

#: Shared latency bucket bounds (milliseconds) for the exported
#: histograms — wide enough to cover sub-ms CPU ticks and multi-second
#: long prefills with one fixed layout, so fleet merges are a plain
#: element-wise add.
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)

#: The per-request phase latencies exported as Prometheus histograms.
HISTOGRAM_NAMES = ("ttft_ms", "itl_ms", "queue_wait_ms", "prefill_chunk_ms")


class LatencyHistogram:
    """Fixed-bucket latency histogram (Prometheus-shaped).

    Buckets are stored NON-cumulative internally (one ``observe`` is a
    single bisect + increment); :meth:`cumulative` renders the
    Prometheus view (running totals ending at the implicit ``+Inf``
    bucket). Fixed shared bounds make :meth:`merge` an element-wise add,
    which keeps fleet aggregation monotone under repeated merges. NOT
    self-locking — the owner (:class:`ServingStats`) already serializes
    access under its lock."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: tuple = LATENCY_BUCKETS_MS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"bucket bounds must be strictly increasing: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, value_ms: float) -> None:
        self.counts[bisect_left(self.bounds, value_ms)] += 1
        self.count += 1
        self.sum += value_ms

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram(self.bounds)
        out.counts = list(self.counts)
        out.count = self.count
        out.sum = self.sum
        return out

    def cumulative(self) -> list:
        """``[(le, cumulative_count)]`` ending at ``("+Inf", count)``."""
        out, running = [], 0
        for bound, c in zip(self.bounds, self.counts):
            running += c
            out.append((bound, running))
        out.append(("+Inf", self.count))
        return out

    def snapshot(self) -> dict:
        return {"bounds": self.bounds, "cumulative": self.cumulative(),
                "sum": round(self.sum, 3), "count": self.count}


class ServingStats:
    """Aggregated serving counters; ``summary()`` is a flat scalar dict
    suitable for ``Accelerator.log`` / tracking payloads."""

    #: TTFT samples kept for percentile reporting (bounded so a long-running
    #: engine cannot grow host memory; newest samples win).
    MAX_TTFT_SAMPLES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        """Zero every counter (e.g. between measurement windows)."""
        with self._lock:
            self._submitted = 0
            self._admitted = 0
            self._completed = 0
            self._failed = 0
            self._cancelled = 0
            self._timed_out = 0
            self._rejected = 0
            self._queue_wait_ms_sum = 0.0
            self._queue_wait_ms_max = 0.0
            self._ttft_ms_sum = 0.0
            self._ttft_ms_max = 0.0
            self._ttft_samples: list[float] = []
            self._ticks = 0
            self._tick_s_sum = 0.0
            self._active_slot_sum = 0
            self._slot_capacity_sum = 0
            self._decode_tokens = 0
            self._prefill_tokens = 0
            self._queue_depth_last = 0
            self._prefill_chunks = 0
            self._prefill_ms_sum = 0.0
            self._prefill_backlog_last = 0
            self._prefill_backlog_max = 0
            self._prefix_lookup_chunks = 0
            self._prefix_hit_chunks = 0
            self._prefix_alias_chunks = 0
            self._prefix_restored_bytes = 0
            self._prefix_cache_bytes = 0
            self._prefix_cache_entries = 0
            # Paged KV pool (gauges sampled each tick + preemption count).
            self._pages_free = 0
            self._pages_used = 0
            self._pages_total = 0
            self._pages_freed = 0
            self._pages_used_max = 0
            self._preemptions = 0
            # Async host runtime: host scheduling/commit wall per tick
            # (microseconds) and emitter backpressure events.
            self._host_us_sum = 0.0
            self._host_us_max = 0.0
            self._host_us_ticks = 0
            self._emission_stalls = 0
            # Speculative decoding: draft proposals vs target acceptances.
            self._spec_ticks = 0
            self._spec_proposed = 0
            self._spec_accepted = 0
            # Prompt-lookup drafting: slots whose n-gram matcher hit.
            self._spec_lookup_slots = 0
            self._spec_lookup_hits = 0
            # Per-adapter (multi-tenant LoRA) counters:
            # name -> {requests, tokens, hits, misses, loads, evictions}.
            self._adapter: dict = {}
            # Per-priority traffic classes (measurement only — scheduling
            # never consults these): name -> {requests, tokens}.
            self._priority: dict = {}
            # Quantized serving: running max of the sampled per-tick
            # |Δlogprob| vs a full-precision reference (bench/tests feed
            # it; 0.0 = never sampled or bit-exact engine).
            self._logprob_drift = 0.0
            # Prometheus-shaped phase-latency histograms (fixed shared
            # buckets; itl_ms observes each decode tick's wall time).
            self._hists = {name: LatencyHistogram()
                           for name in HISTOGRAM_NAMES}

    # -- caller side ----------------------------------------------------
    def record_submit(self, queue_depth: int):
        with self._lock:
            self._submitted += 1
            self._queue_depth_last = int(queue_depth)

    def record_reject(self):
        """A submit bounced off the full admission queue (backpressure)."""
        with self._lock:
            self._rejected += 1

    # -- engine side ----------------------------------------------------
    def record_admit(self, queue_wait_ms: float, ttft_ms: float):
        """One request placed into a slot; TTFT is measured here because the
        first token is emitted by the prefill itself."""
        with self._lock:
            self._admitted += 1
            self._queue_wait_ms_sum += queue_wait_ms
            self._queue_wait_ms_max = max(self._queue_wait_ms_max, queue_wait_ms)
            self._ttft_ms_sum += ttft_ms
            self._ttft_ms_max = max(self._ttft_ms_max, ttft_ms)
            self._ttft_samples.append(ttft_ms)
            if len(self._ttft_samples) > self.MAX_TTFT_SAMPLES:
                del self._ttft_samples[: len(self._ttft_samples) // 2]
            self._prefill_tokens += 1
            self._hists["queue_wait_ms"].observe(queue_wait_ms)
            self._hists["ttft_ms"].observe(ttft_ms)

    def record_tick(self, active_slots: int, committed_tokens: int,
                    max_slots: int, seconds: float,
                    host_us: Optional[float] = None):
        """One ``decode_step_all_slots`` execution.

        ``seconds`` is the device-complete→device-complete interval for
        this tick — what ``itl_ms`` observes. (Pre-async it was per-tick
        wall time; under one-tick-ahead dispatch the two differ, and the
        interval is the one a consumer actually experiences between
        tokens.) ``host_us`` is the tick's host scheduling + commit wall
        in microseconds — the part of the interval NOT spent waiting on
        the device, i.e. the host overhead the async runtime hides."""
        with self._lock:
            self._ticks += 1
            self._tick_s_sum += seconds
            self._active_slot_sum += int(active_slots)
            self._slot_capacity_sum += int(max_slots)
            self._decode_tokens += int(committed_tokens)
            self._hists["itl_ms"].observe(seconds * 1e3)
            if host_us is not None:
                self._host_us_sum += float(host_us)
                self._host_us_max = max(self._host_us_max, float(host_us))
                self._host_us_ticks += 1

    def record_emission_stall(self):
        """A stream was skipped for one tick because its bounded emission
        queue was full (slow ``on_token`` consumer) — flow control held
        the stream back rather than stalling the tick loop."""
        with self._lock:
            self._emission_stalls += 1

    def record_prefill_chunk(self, ms: float, backlog: int = 0):
        """One ``prefill_chunk`` execution; ``backlog`` is the number of
        requests in ``PREFILLING`` at the time of the call (how much
        admission work is still pending behind the per-tick budget)."""
        with self._lock:
            self._prefill_chunks += 1
            self._prefill_ms_sum += ms
            self._hists["prefill_chunk_ms"].observe(ms)
            self._prefill_backlog_last = int(backlog)
            self._prefill_backlog_max = max(self._prefill_backlog_max,
                                            int(backlog))

    def record_prefix(self, looked_up: int, hit: int, bytes_restored: int,
                      aliased: int = 0):
        """One admission's prefix-cache lookup: ``looked_up`` restorable
        chunks were probed, the first ``hit`` of them were restored by
        ``restore_prefix`` instead of recomputed. On the paged engine,
        ``aliased`` of those hits were satisfied by page-table aliasing
        (a host page-id write, zero device copies)."""
        with self._lock:
            self._prefix_lookup_chunks += int(looked_up)
            self._prefix_hit_chunks += int(hit)
            self._prefix_alias_chunks += int(aliased)
            self._prefix_restored_bytes += int(bytes_restored)

    def record_pages(self, free: int, used: int, total: int,
                     freed_total: int = 0):
        """Gauge: paged-KV pool occupancy after a tick (page counts).
        ``freed_total`` mirrors the pool's cumulative free count — the
        page-drain observable behind the gateway's pressure Retry-After."""
        with self._lock:
            self._pages_free = int(free)
            self._pages_used = int(used)
            self._pages_used_max = max(self._pages_used_max, int(used))
            self._pages_total = int(total)
            self._pages_freed = int(freed_total)

    def record_preemption(self):
        """A running request was evicted at a chunk/tick boundary because
        the page pool was exhausted; it re-queues and resumes token-exact
        as a longer prompt."""
        with self._lock:
            self._preemptions += 1

    def record_spec(self, proposed: int, accepted: int,
                    lookup_hits: Optional[int] = None,
                    lookup_slots: int = 0):
        """One speculative tick: the draft proposed ``proposed`` tokens
        across active slots, the target verify accepted ``accepted``
        (committed tokens beyond the one-per-tick baseline count here too:
        accepted / ticks is tokens-per-tick, the headline spec metric).
        Prompt-lookup engines also report how many of the tick's
        ``lookup_slots`` found an n-gram match (``lookup_hits``) — the
        hit rate says whether the traffic shape suits draft-free
        speculation at all."""
        with self._lock:
            self._spec_ticks += 1
            self._spec_proposed += int(proposed)
            self._spec_accepted += int(accepted)
            if lookup_hits is not None:
                self._spec_lookup_slots += int(lookup_slots)
                self._spec_lookup_hits += int(lookup_hits)

    def record_prefix_cache_size(self, nbytes: int, entries: int):
        """Gauge: the prefix cache's current footprint after an insert or
        eviction sweep."""
        with self._lock:
            self._prefix_cache_bytes = int(nbytes)
            self._prefix_cache_entries = int(entries)

    def _adapter_entry(self, name: str) -> dict:
        # call with self._lock held
        entry = self._adapter.get(name)
        if entry is None:
            entry = {"requests": 0, "tokens": 0, "hits": 0, "misses": 0,
                     "loads": 0, "evictions": 0}
            self._adapter[name] = entry
        return entry

    def record_adapter_admit(self, name: str, hit: bool, evicted=None):
        """One adapter request admitted: a residency ``hit`` found the
        adapter already in its bank row; a miss loaded it (possibly
        evicting another tenant, billed to the EVICTED adapter)."""
        with self._lock:
            entry = self._adapter_entry(name)
            entry["requests"] += 1
            if hit:
                entry["hits"] += 1
            else:
                entry["misses"] += 1
                entry["loads"] += 1
            if evicted is not None:
                self._adapter_entry(evicted)["evictions"] += 1

    def record_adapter_tokens(self, name: str, tokens: int):
        """Tokens emitted by one retiring adapter request."""
        with self._lock:
            self._adapter_entry(name)["tokens"] += int(tokens)

    def per_adapter(self) -> dict:
        """``name -> {requests, tokens, hits, misses, loads, evictions}``
        snapshot — the gateway's labeled Prometheus series."""
        with self._lock:
            return {name: dict(entry) for name, entry in self._adapter.items()}

    def _priority_entry(self, name: str) -> dict:
        # call with self._lock held
        entry = self._priority.get(name)
        if entry is None:
            entry = {"requests": 0, "tokens": 0}
            self._priority[name] = entry
        return entry

    def record_priority_request(self, name: str):
        """One request submitted under a client-declared traffic class."""
        with self._lock:
            self._priority_entry(name)["requests"] += 1

    def record_priority_tokens(self, name: str, tokens: int):
        """Tokens emitted by one retiring prioritized request."""
        with self._lock:
            self._priority_entry(name)["tokens"] += int(tokens)

    def per_priority(self) -> dict:
        """``name -> {requests, tokens}`` snapshot — the gateway's labeled
        per-priority Prometheus series (measurement only)."""
        with self._lock:
            return {name: dict(entry)
                    for name, entry in self._priority.items()}

    def record_logprob_drift(self, value: float):
        """Observe one sampled per-tick max |Δlogprob| vs the fp reference
        (quantized engines; the gauge keeps the running max)."""
        with self._lock:
            self._logprob_drift = max(self._logprob_drift, float(value))

    def record_finish(self, status):
        """One request retired; ``status`` is a RequestStatus."""
        from .request import RequestStatus

        with self._lock:
            if status == RequestStatus.COMPLETED:
                self._completed += 1
            elif status == RequestStatus.FAILED:
                self._failed += 1
            elif status == RequestStatus.TIMED_OUT:
                self._timed_out += 1
            else:
                self._cancelled += 1

    # -- aggregation ----------------------------------------------------
    def merge(self, other: "ServingStats") -> "ServingStats":
        """Fold another engine's counters into this one — the fleet
        aggregation the router's ``ReplicaSet``
        publishes (one merged view over N replicas). Sums add, maxima max,
        TTFT samples concatenate (bounded), and point-in-time gauges
        (queue depth, prefill backlog, prefix-cache footprint) ADD — the
        fleet's total queue depth and total cache bytes are the
        operational numbers, not any one replica's. Returns ``self`` so
        merges chain: ``ServingStats().merge(a).merge(b)``."""
        with other._lock:
            o = dict(other.__dict__)
            o_samples = list(other._ttft_samples)
            o_adapter = {name: dict(e) for name, e in other._adapter.items()}
            o_priority = {name: dict(e)
                          for name, e in other._priority.items()}
            o_hists = {name: h.copy() for name, h in other._hists.items()}
        with self._lock:
            for name, hist in o_hists.items():
                mine = self._hists.get(name)
                if mine is None:
                    self._hists[name] = hist
                else:
                    mine.merge(hist)
            for name, entry in o_adapter.items():
                mine = self._adapter_entry(name)
                for k, v in entry.items():
                    mine[k] += v
            for name, entry in o_priority.items():
                mine = self._priority_entry(name)
                for k, v in entry.items():
                    mine[k] += v
            for k in ("_submitted", "_admitted", "_completed", "_failed",
                      "_cancelled", "_timed_out", "_rejected",
                      "_queue_wait_ms_sum", "_ttft_ms_sum", "_ticks",
                      "_tick_s_sum", "_active_slot_sum", "_slot_capacity_sum",
                      "_decode_tokens", "_prefill_tokens", "_prefill_chunks",
                      "_prefill_ms_sum", "_prefix_lookup_chunks",
                      "_prefix_hit_chunks", "_prefix_alias_chunks",
                      "_prefix_restored_bytes",
                      "_queue_depth_last", "_prefill_backlog_last",
                      "_prefix_cache_bytes", "_prefix_cache_entries",
                      "_pages_free", "_pages_used", "_pages_total",
                      "_pages_freed",
                      "_preemptions", "_spec_ticks", "_spec_proposed",
                      "_spec_accepted", "_spec_lookup_slots",
                      "_spec_lookup_hits", "_host_us_sum",
                      "_host_us_ticks", "_emission_stalls"):
                setattr(self, k, getattr(self, k) + o[k])
            for k in ("_queue_wait_ms_max", "_ttft_ms_max",
                      "_prefill_backlog_max", "_host_us_max", "_pages_used_max",
                      "_logprob_drift"):
                setattr(self, k, max(getattr(self, k), o[k]))
            self._ttft_samples.extend(o_samples)
            if len(self._ttft_samples) > self.MAX_TTFT_SAMPLES:
                del self._ttft_samples[: len(self._ttft_samples)
                                       - self.MAX_TTFT_SAMPLES]
        return self

    # -- reporting ------------------------------------------------------
    def histograms(self) -> dict:
        """``name -> {bounds, cumulative, sum, count}`` snapshot of the
        phase-latency histograms — the gateway renders these as
        Prometheus histogram families next to the scalar gauges."""
        with self._lock:
            return {name: h.snapshot() for name, h in self._hists.items()}

    @staticmethod
    def _percentile(samples: list[float], q: float) -> float:
        if not samples:
            return 0.0
        s = sorted(samples)
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[idx]

    def summary(self) -> dict:
        """Scalar snapshot: request counts, queue-wait/TTFT latencies,
        decode tokens/sec, slot occupancy, batch efficiency, and the
        chunked-prefill split (chunk count/ms, backlog, prefill-vs-decode
        ms, prefix-cache hit rate/bytes)."""
        with self._lock:
            admits = max(1, self._admitted)
            caps = max(1, self._slot_capacity_sum)
            samples = list(self._ttft_samples)
            out = {
                "requests_submitted": self._submitted,
                "requests_admitted": self._admitted,
                "requests_completed": self._completed,
                "requests_failed": self._failed,
                "requests_cancelled": self._cancelled,
                "requests_timed_out": self._timed_out,
                "requests_rejected": self._rejected,
                "queue_wait_ms": round(self._queue_wait_ms_sum / admits, 3),
                "queue_wait_ms_max": round(self._queue_wait_ms_max, 3),
                "ttft_ms": round(self._ttft_ms_sum / admits, 3),
                "ttft_ms_p50": round(self._percentile(samples, 0.50), 3),
                "ttft_ms_p95": round(self._percentile(samples, 0.95), 3),
                "ttft_ms_max": round(self._ttft_ms_max, 3),
                "decode_ticks": self._ticks,
                "decode_tokens": self._decode_tokens,
                "tokens_emitted": self._decode_tokens + self._prefill_tokens,
                "decode_tokens_per_sec": round(
                    self._decode_tokens / self._tick_s_sum, 3)
                    if self._tick_s_sum else 0.0,
                "slot_occupancy": round(self._active_slot_sum / caps, 4),
                "batch_efficiency": round(self._decode_tokens / caps, 4),
                "queue_depth": self._queue_depth_last,
                "prefill_chunks": self._prefill_chunks,
                "prefill_ms": round(self._prefill_ms_sum, 3),
                "prefill_ms_per_chunk": round(
                    self._prefill_ms_sum / max(1, self._prefill_chunks), 3),
                "prefill_chunks_per_tick": round(
                    self._prefill_chunks / max(1, self._ticks), 4),
                "prefill_backlog": self._prefill_backlog_last,
                "prefill_backlog_max": self._prefill_backlog_max,
                "decode_ms": round(self._tick_s_sum * 1e3, 3),
                "prefix_cache_hit_rate": round(
                    self._prefix_hit_chunks / self._prefix_lookup_chunks, 4)
                    if self._prefix_lookup_chunks else 0.0,
                "prefix_cache_hit_chunks": self._prefix_hit_chunks,
                "prefix_alias_chunks": self._prefix_alias_chunks,
                "prefix_cache_restored_bytes": self._prefix_restored_bytes,
                "prefix_cache_bytes": self._prefix_cache_bytes,
                "prefix_cache_entries": self._prefix_cache_entries,
                # Paged-KV pool pressure (all zero on a dense engine).
                "pages_total": self._pages_total,
                "pages_free": self._pages_free,
                "pages_used": self._pages_used,
                # The port's one key beyond the JAX package's: the peak.
                "pages_used_max": self._pages_used_max,
                "page_utilization": round(
                    self._pages_used / self._pages_total, 4)
                    if self._pages_total else 0.0,
                "pages_freed": self._pages_freed,
                "preemptions": self._preemptions,
                # Speculative decoding (all zero on a non-spec engine).
                "spec_ticks": self._spec_ticks,
                "spec_proposed_tokens": self._spec_proposed,
                "spec_accepted_tokens": self._spec_accepted,
                "spec_accept_rate": round(
                    self._spec_accepted / self._spec_proposed, 4)
                    if self._spec_proposed else 0.0,
                "spec_tokens_per_tick": round(
                    (self._spec_accepted + self._spec_ticks)
                    / self._spec_ticks, 4)
                    if self._spec_ticks else 0.0,
                "spec_lookup_hit_rate": round(
                    self._spec_lookup_hits / self._spec_lookup_slots, 4)
                    if self._spec_lookup_slots else 0.0,
                # Async host runtime (zero when the engine never reported
                # host timings, e.g. before its first reconcile).
                "host_us_per_tick": round(
                    self._host_us_sum / self._host_us_ticks, 3)
                    if self._host_us_ticks else 0.0,
                "host_us_per_tick_max": round(self._host_us_max, 3),
                "emission_stalls": self._emission_stalls,
                # Quantized serving: sampled bounded-divergence gauge
                # (running max |Δlogprob| vs fp reference; 0.0 when the
                # engine is bit-exact or never sampled).
                "logprob_drift": round(self._logprob_drift, 6),
            }
            # Multi-tenant LoRA: flat aggregates plus per-name counters
            # ("adapter/<name>/<counter>" — slash-pathed like tracker keys;
            # the gateway re-emits these as labeled Prometheus series).
            a_req = sum(e["requests"] for e in self._adapter.values())
            a_hit = sum(e["hits"] for e in self._adapter.values())
            a_lookups = a_hit + sum(e["misses"] for e in self._adapter.values())
            out.update({
                "adapters_tracked": len(self._adapter),
                "adapter_requests": a_req,
                "adapter_tokens": sum(e["tokens"] for e in self._adapter.values()),
                "adapter_loads": sum(e["loads"] for e in self._adapter.values()),
                "adapter_evictions": sum(
                    e["evictions"] for e in self._adapter.values()),
                "adapter_residency_hit_rate": round(a_hit / a_lookups, 4)
                    if a_lookups else 0.0,
            })
            for name in sorted(self._adapter):
                for k, v in self._adapter[name].items():
                    out[f"adapter/{name}/{k}"] = v
            # Traffic classes ("priority/<name>/<counter>", same slash
            # pathing) — measurement-only series for the SLO baseline.
            for name in sorted(self._priority):
                for k, v in self._priority[name].items():
                    out[f"priority/{name}/{k}"] = v
            return out


class GatewayStats:
    """HTTP-layer counters for the :class:`~.gateway.ServingGateway`: responses by route and status code, in-flight
    connections, streamed tokens, and the backpressure/shed classes the
    gateway maps to HTTP (429 queue-full, 408 deadline, 413 body cap,
    503 saturated/draining). Thread-safe — every handler thread records
    into the same object; ``summary()`` is a flat scalar dict and
    ``by_route()`` feeds the labeled Prometheus series."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        """Zero every counter (e.g. between measurement windows)."""
        with self._lock:
            self._responses: dict = {}   # (route, code) -> count
            self._inflight = 0
            self._inflight_max = 0
            self._streams = 0
            self._tokens_streamed = 0
            self._bytes_in = 0
            self._pressure_sheds = 0
            self._rate_limit_sheds = 0
            self._fair_share_sheds = 0
            # SSE saturation observables: how many event-stream responses
            # are OPEN right now (the front end's true concurrency — the
            # number the asyncio refactor exists to scale) and how many
            # requests bounced off the connection cap (503s the open-loop
            # harness counts as refusals, distinct from queue-full 429s).
            self._open_streams = 0
            self._open_streams_max = 0
            self._conn_rejections = 0

    def record_response(self, route: str, code: int, body_bytes: int = 0):
        """One finished HTTP exchange on ``route`` with status ``code``."""
        with self._lock:
            key = (str(route), int(code))
            self._responses[key] = self._responses.get(key, 0) + 1
            self._bytes_in += int(body_bytes)

    def record_pressure_shed(self):
        """One 429 issued on PROJECTED KV-page pressure (pool headroom
        short for admitted + queued demand) rather than queue depth —
        distinguishes proactive sheds from queue-full backpressure in the
        overall 429 count."""
        with self._lock:
            self._pressure_sheds += 1

    def record_rate_limit_shed(self):
        """One 429 issued by the per-tenant token-bucket rate limiter
        (Retry-After derives from the tenant bucket's refill time) —
        per-cause accounting alongside the pressure/queue-full sheds."""
        with self._lock:
            self._rate_limit_sheds += 1

    def record_fair_share_shed(self):
        """One 429 issued by weighted fair-share admission: the fleet was
        past its pressure threshold and this tenant past its guaranteed
        share of in-flight streams."""
        with self._lock:
            self._fair_share_sheds += 1

    def record_stream(self, tokens: int):
        """One SSE stream that delivered ``tokens`` token events."""
        with self._lock:
            self._streams += 1
            self._tokens_streamed += int(tokens)

    def record_conn_rejection(self):
        """One request refused (503) at the connection cap — saturation of
        the FRONT END itself, visible on /metrics before any load harness
        goes looking for it."""
        with self._lock:
            self._conn_rejections += 1

    def stream_enter(self):
        """An SSE response opened (headers sent, events may follow)."""
        with self._lock:
            self._open_streams += 1
            self._open_streams_max = max(self._open_streams_max,
                                         self._open_streams)

    def stream_exit(self):
        """An SSE response closed (final event written or socket broke)."""
        with self._lock:
            self._open_streams -= 1

    def inflight_enter(self):
        with self._lock:
            self._inflight += 1
            self._inflight_max = max(self._inflight_max, self._inflight)

    def inflight_exit(self):
        with self._lock:
            self._inflight -= 1

    def by_route(self) -> dict:
        """``(route, code) -> count`` snapshot (Prometheus labels)."""
        with self._lock:
            return dict(self._responses)

    def summary(self) -> dict:
        """Flat scalar snapshot: totals, per-class counts, in-flight."""
        with self._lock:
            total = sum(self._responses.values())

            def klass(digit):
                return sum(c for (_, code), c in self._responses.items()
                           if code // 100 == digit)

            def code_count(code):
                return sum(c for (_, c2), c in self._responses.items()
                           if c2 == code)

            return {
                "http_requests": total,
                "http_2xx": klass(2),
                "http_4xx": klass(4),
                "http_5xx": klass(5),
                "http_429": code_count(429),
                "http_408": code_count(408),
                "http_413": code_count(413),
                "http_503": code_count(503),
                "http_inflight": self._inflight,
                "http_inflight_max": self._inflight_max,
                "streams": self._streams,
                "tokens_streamed": self._tokens_streamed,
                "request_bytes_in": self._bytes_in,
                "pressure_sheds": self._pressure_sheds,
                "rate_limit_sheds": self._rate_limit_sheds,
                "fair_share_sheds": self._fair_share_sheds,
                "open_sse_streams": self._open_streams,
                "open_sse_streams_max": self._open_streams_max,
                "conn_rejections": self._conn_rejections,
            }
