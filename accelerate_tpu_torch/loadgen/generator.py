"""Arrival schedules, traffic profiles, and the asyncio open-loop driver.

Counterpart of ``accelerate_tpu/loadgen/generator.py``.

Everything here is seeded and deterministic given the seed: a schedule
is a *plan* (arrival offsets and request shapes fixed up front), and
``run_open_loop`` executes the plan against a live gateway from one
event loop, timestamping every stream against its scheduled arrival.
The driver speaks raw HTTP/1.1 over :func:`asyncio.open_connection` —
no client library, same stdlib-only rule as the gateway itself.
"""

from __future__ import annotations

import asyncio
import json
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["ArrivalSchedule", "TrafficProfile", "StreamResult",
           "run_open_loop", "fetch_gateway_metrics"]


class ArrivalSchedule:
    """Seeded open-loop arrival plan: ``n`` streams, inter-arrival times
    drawn from a heavy-tailed (or uniform) distribution with a target
    mean, cumulated into arrival offsets starting at zero.

    The offered rate is a property of this object computed before any
    request is sent — ``run_open_loop`` dispatches on this clock no
    matter how the server is doing, which is what makes the load
    open-loop. Heavy tails matter: Poisson-ish smooth arrivals hide the
    burst behaviour that actually collapses queues, so the default is
    lognormal with a fat sigma, and ``dist="pareto"`` goes fatter.

    Args:
      n: number of streams.
      mean_interarrival_s: target mean gap between consecutive arrivals
        (``1 / offered_rps`` to first order).
      dist: ``"lognormal"`` (default), ``"pareto"``, or ``"uniform"``.
      sigma: lognormal log-space sigma (burstiness; 0 → near-constant).
      alpha: Pareto tail index (must be > 1 so the mean exists; closer
        to 1 → heavier tail).
      seed: RNG seed; the same seed always yields the same schedule.
    """

    DISTS = ("lognormal", "pareto", "uniform")

    def __init__(self, n: int, mean_interarrival_s: float, *,
                 dist: str = "lognormal", sigma: float = 1.0,
                 alpha: float = 1.5, seed: int = 0):
        if n < 1:
            raise ValueError("n must be >= 1")
        if mean_interarrival_s <= 0:
            raise ValueError("mean_interarrival_s must be > 0")
        if dist not in self.DISTS:
            raise ValueError(f"dist must be one of {self.DISTS} "
                             f"(got {dist!r})")
        if alpha <= 1:
            raise ValueError("alpha must be > 1 (finite-mean Pareto)")
        self.n = int(n)
        self.mean_interarrival_s = float(mean_interarrival_s)
        self.dist = dist
        self.sigma = float(sigma)
        self.alpha = float(alpha)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        m = self.mean_interarrival_s
        if dist == "lognormal":
            # mean of LogNormal(mu, sigma) is exp(mu + sigma^2/2);
            # solve mu for the requested mean.
            mu = np.log(m) - self.sigma ** 2 / 2.0
            gaps = rng.lognormal(mu, self.sigma, size=n)
        elif dist == "pareto":
            # Lomax+1 scaled so the mean is alpha*xm/(alpha-1) == m.
            xm = m * (self.alpha - 1.0) / self.alpha
            gaps = (rng.pareto(self.alpha, size=n) + 1.0) * xm
        else:
            gaps = rng.uniform(0.0, 2.0 * m, size=n)
        gaps[0] = 0.0  # first arrival defines t=0
        self._offsets = np.cumsum(gaps)

    def offsets(self) -> np.ndarray:
        """Arrival offsets in seconds from run start, ascending,
        ``offsets()[0] == 0``."""
        return self._offsets.copy()

    @property
    def span_s(self) -> float:
        """Seconds between the first and last scheduled arrival."""
        return float(self._offsets[-1] - self._offsets[0])

    @property
    def offered_rps(self) -> float:
        """Offered arrival rate over the schedule span (n-1 gaps)."""
        if self.n == 1 or self.span_s == 0:
            return float("inf") if self.n > 1 else 0.0
        return (self.n - 1) / self.span_s

    def describe(self) -> dict:
        return {
            "n": self.n,
            "dist": self.dist,
            "mean_interarrival_s": self.mean_interarrival_s,
            "sigma": self.sigma,
            "alpha": self.alpha,
            "seed": self.seed,
            "span_s": self.span_s,
            "offered_rps": self.offered_rps,
        }


class TrafficProfile:
    """Seeded per-stream request shapes: heavy-tailed prompt/output
    lengths plus a mixed adapter / sampling-seed / priority blend.

    Lengths are lognormal around a median (the natural heavy-tail
    parameterisation: half the requests are short, a tail is very
    long), clipped into ``[min, max]`` so the engine's ``max_len``
    budget is respected by construction. ``adapters`` is a weighted mix
    where ``None`` means the base model; ``priorities`` ride in the
    request payload and the gateway carries them end to end into the
    engine's per-priority metrics series (measurement only — the
    baseline the SLO-control roadmap item will schedule on).
    """

    def __init__(self, *, prompt_len_median: int = 32,
                 prompt_len_sigma: float = 0.6,
                 prompt_len_min: int = 1, prompt_len_max: int = 128,
                 out_tokens_median: int = 16,
                 out_tokens_sigma: float = 0.6,
                 out_tokens_min: int = 1, out_tokens_max: int = 64,
                 adapters=((None, 1.0),),
                 sampled_fraction: float = 0.5,
                 priorities=(("interactive", 0.8), ("batch", 0.2)),
                 timeout_s: Optional[float] = None,
                 seed: int = 0):
        if prompt_len_min < 1 or prompt_len_max < prompt_len_min:
            raise ValueError("need 1 <= prompt_len_min <= prompt_len_max")
        if out_tokens_min < 1 or out_tokens_max < out_tokens_min:
            raise ValueError("need 1 <= out_tokens_min <= out_tokens_max")
        if not 0.0 <= sampled_fraction <= 1.0:
            raise ValueError("sampled_fraction must be in [0, 1]")
        self.prompt_len_median = int(prompt_len_median)
        self.prompt_len_sigma = float(prompt_len_sigma)
        self.prompt_len_min = int(prompt_len_min)
        self.prompt_len_max = int(prompt_len_max)
        self.out_tokens_median = int(out_tokens_median)
        self.out_tokens_sigma = float(out_tokens_sigma)
        self.out_tokens_min = int(out_tokens_min)
        self.out_tokens_max = int(out_tokens_max)
        self.adapters = tuple(adapters)
        self.sampled_fraction = float(sampled_fraction)
        self.priorities = tuple(priorities)
        self.timeout_s = timeout_s
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def _weighted(self, choices):
        names = [c[0] for c in choices]
        w = np.asarray([c[1] for c in choices], float)
        return names[int(self._rng.choice(len(names), p=w / w.sum()))]

    def _length(self, median, sigma, lo, hi) -> int:
        # median of LogNormal(mu, sigma) is exp(mu).
        v = self._rng.lognormal(np.log(median), sigma)
        return int(np.clip(round(v), lo, hi))

    def sample(self, vocab_size: int = 256) -> dict:
        """One request body (JSON-ready dict) for ``POST
        /v1/completions``; ``stream`` is set by the driver."""
        plen = self._length(self.prompt_len_median, self.prompt_len_sigma,
                            self.prompt_len_min, self.prompt_len_max)
        body = {
            "prompt": self._rng.integers(
                0, vocab_size, size=plen).tolist(),
            "max_new_tokens": self._length(
                self.out_tokens_median, self.out_tokens_sigma,
                self.out_tokens_min, self.out_tokens_max),
            "ignore_eos": True,
            "priority": self._weighted(self.priorities),
        }
        adapter = self._weighted(self.adapters)
        if adapter is not None:
            body["adapter"] = adapter
        if float(self._rng.random()) < self.sampled_fraction:
            body["seed"] = int(self._rng.integers(0, 2 ** 31 - 1))
        if self.timeout_s is not None:
            body["timeout"] = self.timeout_s
        return body

    def describe(self) -> dict:
        return {
            "prompt_len": [self.prompt_len_median, self.prompt_len_sigma,
                           self.prompt_len_min, self.prompt_len_max],
            "out_tokens": [self.out_tokens_median, self.out_tokens_sigma,
                           self.out_tokens_min, self.out_tokens_max],
            "adapters": [[a, w] for a, w in self.adapters],
            "sampled_fraction": self.sampled_fraction,
            "priorities": [[p, w] for p, w in self.priorities],
            "timeout_s": self.timeout_s,
            "seed": self.seed,
        }


@dataclass
class StreamResult:
    """Everything measured about one scheduled stream. Times are
    seconds on the client loop clock; TTFT/ITL are measured from the
    SCHEDULED arrival, so a stream the saturated server accepted late
    (or never) still counts against the tail."""

    index: int
    scheduled_s: float              # offset from run start
    sent_s: Optional[float] = None  # actual first-byte-out offset
    code: Optional[int] = None      # HTTP status (None: connect failure)
    ttft_s: Optional[float] = None  # first token event - scheduled
    token_gaps_s: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    done: Optional[dict] = None     # the SSE final summary payload
    retry_after_s: Optional[float] = None
    heartbeats: int = 0
    truncated: bool = False         # SSE body ended without a done event
    aborted: bool = False           # client-side wall-deadline abort
    error: Optional[str] = None
    request: Optional[dict] = None  # the body sent (token accounting)

    @property
    def completed(self) -> bool:
        return (self.code == 200 and self.done is not None
                and self.done.get("status") == "completed")


async def _read_headers(reader) -> dict:
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            return headers
        name, sep, value = line.decode("latin-1").partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()


async def _one_stream(host: str, port: int, res: StreamResult,
                      body: dict, t0: float,
                      connect_timeout: float) -> None:
    loop = asyncio.get_running_loop()
    res.request = body
    payload = json.dumps(dict(body, stream=True)).encode()
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), connect_timeout)
    except Exception as e:
        res.error = f"connect: {type(e).__name__}: {e}"
        return
    try:
        res.sent_s = loop.time() - t0
        writer.write(
            b"POST /v1/completions HTTP/1.1\r\n"
            b"Host: loadgen\r\n"
            b"Content-Type: application/json\r\n"
            b"Connection: close\r\n"
            + f"Content-Length: {len(payload)}\r\n\r\n".encode()
            + payload)
        await writer.drain()
        status_line = await reader.readline()
        parts = status_line.decode("latin-1").split()
        if len(parts) < 2 or not parts[1].isdigit():
            res.error = f"bad status line: {status_line!r}"
            return
        res.code = int(parts[1])
        headers = await _read_headers(reader)
        if "retry-after" in headers:
            try:
                res.retry_after_s = float(headers["retry-after"])
            except ValueError:
                res.retry_after_s = -1.0  # present but unparseable
        ctype = headers.get("content-type", "")
        if "text/event-stream" not in ctype:
            n = int(headers.get("content-length", 0))
            raw = await reader.readexactly(n) if n else b""
            try:
                res.done = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                res.error = "unparseable JSON body"
            return
        # SSE: events separated by blank lines, EOF-terminated.
        last_event_t = None
        data_lines = []
        while True:
            line = await reader.readline()
            if line == b"":
                res.truncated = res.done is None
                return
            line = line.rstrip(b"\r\n")
            if line.startswith(b":"):
                res.heartbeats += 1
                continue
            if line.startswith(b"data:"):
                data_lines.append(line[5:].strip())
                continue
            if line:
                continue  # unknown field; ignore per SSE spec
            if not data_lines:
                continue  # empty event
            event = json.loads(b"\n".join(data_lines))
            data_lines = []
            now = loop.time() - t0
            if event.get("done"):
                res.done = event
            elif "token" in event:
                res.tokens.append(int(event["token"]))
                if res.ttft_s is None:
                    res.ttft_s = now - res.scheduled_s
                else:
                    res.token_gaps_s.append(now - last_event_t)
                last_event_t = now
    except asyncio.IncompleteReadError:
        res.truncated = True
    except asyncio.CancelledError:
        res.aborted = True
        raise
    except Exception as e:  # measurement must survive any one stream
        res.error = f"{type(e).__name__}: {e}"
    finally:
        try:
            writer.close()
        except Exception:
            pass


async def _run_open_loop_async(host: str, port: int,
                               schedule: ArrivalSchedule,
                               profile: TrafficProfile, *,
                               vocab_size: int,
                               connect_timeout: float,
                               wall_deadline_s: Optional[float],
                               on_started=None) -> list:
    loop = asyncio.get_running_loop()
    offsets = schedule.offsets()
    bodies = [profile.sample(vocab_size) for _ in range(schedule.n)]
    t0 = loop.time()
    results = [StreamResult(index=i, scheduled_s=float(offsets[i]))
               for i in range(schedule.n)]

    async def _dispatch(i):
        delay = t0 + offsets[i] - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        await _one_stream(host, port, results[i], bodies[i], t0,
                          connect_timeout)

    tasks = [asyncio.ensure_future(_dispatch(i))
             for i in range(schedule.n)]
    if on_started is not None:
        on_started(tasks)
    gather = asyncio.gather(*tasks, return_exceptions=True)
    if wall_deadline_s is not None:
        try:
            await asyncio.wait_for(asyncio.shield(gather), wall_deadline_s)
        except asyncio.TimeoutError:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
    else:
        await gather
    return results


def run_open_loop(url: str, schedule: ArrivalSchedule,
                  profile: TrafficProfile, *, vocab_size: int = 256,
                  connect_timeout: float = 10.0,
                  wall_deadline_s: Optional[float] = None) -> dict:
    """Execute the schedule against a gateway at ``url`` from one
    asyncio client loop. Returns ``{"results": [StreamResult...],
    "wall_s": float, "process_cpu_s": float}`` — CPU is
    ``time.process_time`` over the run, i.e. client + (for in-process
    gateways, which is how the tests run) server host cost together.

    ``wall_deadline_s`` bounds the whole run: streams still open at the
    deadline are aborted client-side (their sockets close, exercising
    the gateway's broken-socket cancel) and marked ``aborted`` — they
    count as not-completed in the report, never as errors.
    """
    parsed = urllib.parse.urlsplit(url)
    host, port = parsed.hostname, parsed.port
    if host is None or port is None:
        raise ValueError(f"url must carry an explicit host:port ({url!r})")
    cpu0 = time.process_time()
    wall0 = time.perf_counter()
    results = asyncio.run(_run_open_loop_async(
        host, port, schedule, profile, vocab_size=vocab_size,
        connect_timeout=connect_timeout, wall_deadline_s=wall_deadline_s))
    return {
        "results": results,
        "wall_s": time.perf_counter() - wall0,
        "process_cpu_s": time.process_time() - cpu0,
    }


def fetch_gateway_metrics(url: str, names=("open_sse_streams",
                                           "open_sse_streams_max",
                                           "conn_rejections",
                                           "pressure_sheds")) -> dict:
    """Scrape ``GET /metrics`` and pull out the named
    ``accelerate_tpu_gateway_*`` families (queue-depth / saturation
    observability for reports). Unknown names are simply absent."""
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
        text = r.read().decode()
    out = {}
    want = {f"accelerate_tpu_gateway_{n}": n for n in names}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 2 and parts[0] in want:
            out[want[parts[0]]] = float(parts[1])
    return out
