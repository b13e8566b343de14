"""Traffic kind ``open_loop_serve``: requests from independent users,
offered to the program's ``ServingEngine`` on an open-loop schedule and
streamed back through ``on_token``, in this process.

The schedule: ``n`` arrivals at ``rate`` per second (``arrivals``: the
gaps' distribution of :class:`~portbench.yardstick.ArrivalSchedule`), each
with a prompt of unique random tokens and an output length, lognormal and
clipped (``prompt``, ``output``). The arrival times and the lengths are
drawn from the cell's ``shape_seed``; the run's seed draws the tokens (and
the weights), so every seed offers the same work: the spread of a cell's
runs is the system's, not the draw's.

Timing, from the client's side: the first ``warmup_s`` seconds of the
schedule fill the engine and are not measured; the window is the next
``--seconds``. Arrivals go on past the window until every request due in
it has its first token (at most ``first_token_wait_s``).

* ``ttft_p95_ms``: first token time less the time the request was due, of
  every request due in the window; one that fails or never gets a token
  counts as unbounded.
* ``itl_p95_ms``: every gap between two tokens of one request whose later
  token came in the window.
* ``serve_tokens_per_s``: tokens that came in the window over its length.

A traced run profiles ``trace_s`` seconds in the middle of the window (the
engine's counters are then those of the window's first part, before the
profiler's start, which stalls the process), and over the same seconds
times each engine step on the device with CUDA events: the benchmark
wraps the engine's step runner (``engine._graphs.run``) to record an event
before and after each step on the engine's stream. A traced run on the
card in which that wrap logged no step fails, rather than leave the step
metrics out of its line.

The check: once arrivals stop and the requests due in the window have
finished (at most ``drain_s``), ``check_requests`` of them, drawn from the
seed with the longest among them, go to the plain reference
(:mod:`portbench.reference.dense_decoder`) with their served tokens, after
the engine and the model are freed.
"""

from __future__ import annotations

import bisect
import gc
import math
import time

import numpy as np
import torch

from portbench import compare, port
from portbench import trace as T
from portbench import weights as W
from portbench.core import process_seconds
from portbench.reference import dense_decoder
from portbench.yardstick import ArrivalSchedule, lognormal_lengths, percentile


class Plan:
    """The requests of one run: due offsets (s), prompts, output lengths."""

    def __init__(self, p: dict, vocab: int, n: int, seed: int):
        shape = np.random.default_rng(p["shape_seed"])
        arrivals = p["arrivals"]
        offsets = ArrivalSchedule(n, 1.0 / p["rate"], dist=arrivals["dist"],
                                  sigma=arrivals.get("sigma", 1.0),
                                  seed=p["shape_seed"]).offsets()
        self.outputs = lognormal_lengths(n, rng=shape, **_law(p["output"]))
        lengths = lognormal_lengths(n, rng=shape, **_law(p["prompt"]))
        run = np.random.default_rng([int(seed) % 2**64, 2])
        self.offsets = offsets
        self.prompts = [run.integers(3, vocab, size=int(m)) for m in lengths]


def _law(spec: dict) -> dict:
    return dict(median=spec["median"], sigma=spec["sigma"], low=spec["min"], high=spec["max"])


class _Stream:
    """One request as its client saw it."""

    def __init__(self, index: int, due: float):
        self.index, self.due = index, due
        self.times: list = []
        self.tokens: list = []
        self.handle = None
        self.refused = False

    def on_token(self, token: int):
        self.times.append(time.monotonic())
        self.tokens.append(int(token))


class _Launches:
    """The engine's step runner, wrapped: while ``on``, each step runs
    between two CUDA events on the engine's stream and is logged with its
    name and time, so the device time of each decode and chunk step is
    known without the profiler."""

    def __init__(self, graphs):
        self.inner = graphs.run
        graphs.run = self.run
        self.on = False
        self.log: list = []

    def run(self, name, step, signature):
        if not self.on:
            return self.inner(name, step, signature)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.inner(name, step, signature)
        end.record()
        self.log.append((name, time.monotonic(), start, end))

    def device_ms(self) -> dict:
        """``{step name: [(monotonic time, device ms), ...]}``."""
        out: dict = {}
        for name, t, start, end in self.log:
            end.synchronize()
            out.setdefault(name, []).append((t, start.elapsed_time(end)))
        return out


def _due_in(streams, a, b):
    return [s for s in streams if a <= s.due < b]


def _live(streams, plan, t: float) -> tuple:
    """Active streams at ``t`` (first token in, last not yet) and their
    live tokens (prompt and tokens so far)."""
    slots = tokens = 0
    for s in streams:
        if not s.times or s.times[0] > t or s.times[-1] <= t:
            continue
        slots += 1
        tokens += len(plan.prompts[s.index]) + bisect.bisect_right(s.times, t)
    return slots, tokens


def run(cell):
    model, prompts, served = serve(cell)
    del model
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = reference_gaps(cell.config, cell.seed, getattr(torch, cell.params["dtype"]),
                             cell.device, prompts, served)
    limits = cell.spec["limits"]
    cell.checks = {"correct": compare.verdict(numbers, limits),
                   "lines": compare.check_lines(numbers, limits)}
    cell.note(f"reference: {len(prompts)} requests, {sum(len(t) for t in served)} served "
              f"tokens, {time.perf_counter() - t_ref:.3f} s; widest gap "
              f"{numbers.get('logit_gap')} (not compared)")


def build(cell):
    """The program's model, with the seed's weights, and its engine (warmed
    up: every step captured)."""
    from accelerate_tpu_torch.serving import ServingEngine

    dtype = getattr(torch, cell.params["dtype"])
    model = port.build_model(cell.config, cell.seed, cell.device, dtype)
    engine = ServingEngine(model, device=cell.device, cache_dtype=dtype,
                           **cell.params["engine"])
    return model, engine


def plan_for(cell) -> "Plan":
    p = cell.params
    n = int(math.ceil(p["rate"] * (p["warmup_s"] + cell.seconds + p["first_token_wait_s"]))) + 16
    return Plan(p, cell.config["vocab_size"], n, cell.seed)


class Window:
    """One pass of a plan through the engine, as the client saw it."""

    def __init__(self, cell, engine, plan, launches=None):
        from accelerate_tpu_torch.serving.scheduler import QueueFull

        p = cell.params
        self.plan = plan
        base = time.monotonic() + 0.05
        self.w0, self.w1 = base + p["warmup_s"], base + p["warmup_s"] + cell.seconds
        self.streams = [_Stream(i, base + float(plan.offsets[i]))
                        for i in range(len(plan.prompts))]
        self.measured = _due_in(self.streams, self.w0, self.w1)
        self.setup_s = self.summary = self.lookups = self.prof = None
        self.launches = launches
        self.lateness = 0.0
        mid = (self.w0 + self.w1) / 2
        actions = [(self.w0, self._open), (self.w1, self._snapshot)]
        if cell.trace:
            actions += [(mid - p["trace_s"] / 2, self._profile),
                        (mid + p["trace_s"] / 2, self._unprofile)]
        actions.sort(key=lambda a: a[0])
        for s in self.streams:
            self._until(s.due, actions, engine)
            now = time.monotonic()
            if now >= self.w1 and (all(m.times or m.refused for m in self.measured)
                                   or now >= self.w1 + p["first_token_wait_s"]):
                break
            self.lateness = max(self.lateness, now - s.due)
            try:
                s.handle = engine.submit(plan.prompts[s.index][None, :],
                                         max_new_tokens=int(plan.outputs[s.index]),
                                         ignore_eos=True, on_token=s.on_token)
            except QueueFull:
                s.refused = True
        for _, act in actions:
            act(engine)
        deadline = time.monotonic() + p["drain_s"]
        for m in self.measured:
            if m.handle is not None:
                m.handle.wait(max(0.0, deadline - time.monotonic()))

    @staticmethod
    def _until(t, actions, engine):
        """Sleep until ``t``, running the actions due before it on time."""
        while actions and actions[0][0] <= t:
            when, act = actions.pop(0)
            time.sleep(max(0.0, when - time.monotonic()))
            act(engine)
        time.sleep(max(0.0, t - time.monotonic()))

    def _open(self, engine):
        self.setup_s = process_seconds()
        engine.stats.reset()

    def _snapshot(self, engine):
        """The engine's counters since the window opened, once: at its
        close, or in a traced run just before the profiler starts (its
        start stalls the process, so the counters are of the rest)."""
        if self.summary is None:
            self.summary = engine.stats.summary()
            self.lookups = engine.stats._prefix_lookup_chunks

    def _profile(self, engine):
        self._snapshot(engine)
        self.prof = T.profiler()
        self.prof.start()
        if self.launches is not None:
            self.launches.on = True

    def _unprofile(self, engine):
        if self.launches is not None:
            self.launches.on = False
        self.prof.stop()

    def metrics(self) -> dict:
        """The end-to-end metrics, from the client's side."""
        w0, w1 = self.w0, self.w1
        ttft = [(m.times[0] - m.due) * 1e3 if m.times else math.inf for m in self.measured]
        gaps = [(b - a) * 1e3 for s in self.streams for a, b in zip(s.times, s.times[1:])
                if w0 <= b < w1]
        tokens = sum(1 for s in self.streams for t in s.times if w0 <= t < w1)
        return {"ttft_p95_ms": percentile(ttft, 95), "itl_p95_ms": percentile(gaps, 95),
                "serve_tokens_per_s": tokens / (w1 - w0), "setup_s": self.setup_s,
                "ttft_p50_ms": percentile(ttft, 50), "itl_samples": len(gaps),
                "tokens_in_window": tokens}

    def failed(self) -> int:
        return sum(1 for m in self.measured if not m.times or m.refused
                   or (m.handle is not None and m.handle.status.value in
                       ("failed", "timed_out", "cancelled")))


def serve(cell):
    """Set-up, the window and the check's sample: fills in ``cell`` and
    returns the program's model (the engine shut down) with the sampled
    requests' prompts and served tokens."""
    p, device = cell.params, cell.device
    plan = plan_for(cell)
    if cell.trace:
        # The profiler's first start sets CUPTI up, which stalls the
        # process for seconds: do it here, not in the window.
        with T.profiler():
            torch.zeros(1, device=device)
    model, engine = build(cell)
    launches = _Launches(engine._graphs) if cell.trace and device.type == "cuda" else None
    window = Window(cell, engine, plan, launches)
    found = window.metrics()
    cell.attempted, cell.failed = len(window.measured), window.failed()
    cell.end_to_end = {k: found[k] for k in ("ttft_p95_ms", "itl_p95_ms",
                                             "serve_tokens_per_s", "setup_s")}
    cell.counters = {"serving": window.summary, "prefix_lookup_chunks": window.lookups,
                     "requests_in_window": len(window.measured),
                     "itl_samples": found["itl_samples"],
                     "generator_lateness_s": window.lateness}
    cell.note(f"window: {len(window.measured)} requests due, {found['itl_samples']} gaps, "
              f"{found['tokens_in_window']} tokens; ttft p50 {found['ttft_p50_ms']} ms; "
              f"set-up {window.setup_s} s; generator late by at most {window.lateness:.4f} s")
    if window.prof is not None:
        cell.device_trace = T.read(window.prof)
    if launches is not None:
        steps = launches.device_ms()
        if not steps:
            raise RuntimeError("the engine's step runner (engine._graphs.run) logged no step "
                               "in the traced seconds: the step metrics have nothing to read")
        cell.counters["step_device_ms"] = {k: [ms for _, ms in v] for k, v in steps.items()}
        live = [_live(window.streams, plan, t) for t, _ in steps.get("decode", [])]
        if live:
            cell.counters.update(decode_slots=float(np.mean([a for a, _ in live])),
                                 decode_live_tokens=float(np.mean([b for _, b in live])))

    finished = [m for m in window.measured if m.handle is not None
                and m.handle.status.value == "completed"]
    picked = _check_sample(finished, plan, p["check_requests"], cell.seed)
    engine.shutdown(drain=False)
    if device.type == "cuda":
        cell.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del engine
    return model, [plan.prompts[m.index] for m in picked], [m.tokens for m in picked]


def _check_sample(finished, plan, count: int, seed: int) -> list:
    """``count`` finished requests drawn from the seed, the longest
    (prompt and output) among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda m: len(plan.prompts[m.index]) + len(m.tokens))
    rest = [m for m in finished if m is not longest]
    rng = np.random.default_rng([int(seed) % 2**64, 3])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_sequences(prompts: list, served: list, device) -> tuple:
    """The reference's inputs: each prompt with its served tokens but the
    last, and the positions whose logits chose the served tokens."""
    seqs, picks = [], []
    for prompt, tokens in zip(prompts, served):
        ids = np.concatenate([prompt, np.asarray(tokens[:-1], np.int64)])
        seqs.append(torch.as_tensor(ids, device=device))
        picks.append(torch.arange(len(prompt) - 1, len(ids), device=device))
    return seqs, picks


def reference_gaps(cfg, seed, dtype, device, prompts: list, served: list) -> dict:
    """The served tokens' gaps under the plain reference
    (:func:`portbench.compare.logit_gaps`), with the seed's weights made
    anew a layer at a time; nothing when there is nothing to compare."""
    if not prompts:
        return {}
    seqs, picks = reference_sequences(prompts, served, device)
    ends = W.make_ends(cfg, seed, device, dtype)
    logits = dense_decoder.logits_at(cfg, ends, lambda i: W.make_layer(cfg, seed, i, device,
                                                                       dtype), seqs, picks)
    return compare.logit_gaps(logits, [torch.as_tensor(t) for t in served])
