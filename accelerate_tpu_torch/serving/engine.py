"""Continuous-batching serving engine on one GPU, over fixed-shape steps.

Counterpart of ``accelerate_tpu/serving/engine.py``. The JAX engine runs a
fixed set of compiled programs whatever the traffic; here each of them is a
step of fixed shape that reads its inputs from static tensors, and on the
card each step is captured once as a CUDA graph and replayed
(:mod:`.graphs`). The engine owns a fixed ``[max_slots, max_len]`` decode
state (per-slot KV, write position, last token, EOS latch and sampling
seed) and, after warmup, runs these steps and nothing else:

* ``decode`` (JAX ``_decode_fn`` ``:1260``, ``_paged_decode_fn`` ``:1591``)
  — one token for every slot a tick: ONE batched forward over the
  ``max_slots`` rows, each at its own position (the JAX engine vmaps a
  batch-1 forward over the slots), through the same
  :func:`generation._next_token` as offline ``generate``. Slot membership
  is a mask copied into the step's input, never a shape.
* ``chunk`` (``_prefill_chunk_fn`` ``:1189``, ``_paged_prefill_chunk_fn``
  ``:1394``) — one ``[1, prefill_chunk]`` prompt chunk at a tensor offset:
  a prompt of any length is a run of identical chunk calls (the tail chunk
  edge-padded on the host, the final chunk's offset pulled back so it stays
  in bounds). It selects the candidate first token through
  :func:`generation._chunk_prefill_token` and, where the prefix cache
  restores by copy, also returns the chunk's KV block.
* ``restore`` (``_restore_prefix_fn`` ``:1240``,
  ``_paged_restore_prefix_fn`` ``:1493``) — copies a cached chunk block
  into a slot, so a prompt whose chunk-aligned prefix is cached skips those
  chunks. A paged engine with its own prefix cache restores by ALIASING the
  cached pages in its page table (host work, no device copy, no step).

Garbage KV is safe for the JAX engine's reasons (``engine.py:57-70``): the
attention mask attends ``k_pos <= q_pos`` only and masks by replacement, so
a masked key adds exactly 0; every chunk and restore call pins
``pos[slot] = true_len``, so the decode tick's unconditional cache commit
writes a mid-prefill slot's garbage at a position no prompt chunk reads;
``pos``/``tok``/``done`` advance only where the mask is set.

Paged KV (``paged=True``, the default): a pool of ``page_size``-token pages
per layer plus a host page table ``[max_slots, pages_per_slot]`` that
rides into the steps as data. Page 0 is scratch: unallocated entries point
at it, and the decode tick sends the writes of slots outside the mask
there. Each layer gathers its rows' views inside its own attention (the JAX
engine gathers all layers' views up front), and the new token's K/V is
written straight into its page. The K/V (pages, or dense slot rows) is
kept head-major, ``[.., n_kv, tokens, hd]``, so a view is one gather of
whole (page, head) blocks and one f32 cast (on an H100 at Llama-3-8B widths,
8 slots x 2048 tokens: 18.9 ms a graphed tick, against 24.0 ms for
token-major pages and the einsum; PERF.md). A pool that runs
dry preempts the newest stream, which later resumes token-exactly as a
longer prompt.

Sampling: a draw is keyed by the request's seed and the position of the
token drawn, never by the slot or its neighbours, through Gumbel-max over
the warped logits with noise from a counter-based hash (:func:`_gumbel`).
The same seed gives the same tokens whatever the slot, batch mix, ticking
mode, layout, or a preemption in between, and the law is the JAX engine's
(``jax.random.categorical`` is Gumbel-max over the same warped logits);
threefry's bits are not matched.

The ASYNC host runtime (``async_ticks=True``, the default) launches tick
N+1 on the engine's stream before it reads tick N's tokens, as the JAX
engine does on its futures (``engine.py:108-140``): the host view is stale
by the one in-flight tick, streams within one token of their budget sit
the ahead tick out, and pages are covered one position ahead. Host inputs
reach the steps' static tensors through pinned staging buffers, double
buffered for the tick so that preparing tick N+2 never overwrites tick
N+1's pending copy; each tick's page-table copy is its snapshot. Tokens
come back with one non-blocking copy and an event a tick. Streaming
callbacks run on an emitter thread; a slow consumer is flow-controlled.

The engine runs its own thread, which sets ``torch.inference_mode`` and
the engine's CUDA stream for itself and captures the graphs at warmup.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: engine speculation (``draft_model``, ``spec_lookup``),
int8 KV pages, the monolithic ``prefill_chunk=None`` path and sliding-window
(ring) models (A5); ``adapters`` and ``weights_dtype`` (A6); ``chaos`` and
``trace_dir`` (A7); ``tp``, ``mesh`` and ``devices`` (A8).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..generation import _check_position_bound, _chunk_prefill_token, _make_warper, _next_token
from ..observability import FlightRecorder, Tracer, new_trace_id
from ..utils.device import resolve_device
from ..utils.profiling import GraphCaptureWatcher
from .control import PriorityPolicy
from .graphs import StepGraphs
from .metrics import ServingStats
from .request import Request, RequestStatus
from .scheduler import AdmissionQueue, PagePool, PrefixCache, QueueClosed, QueueFull, SlotScheduler

__all__ = ["ServingEngine"]

#: distinct tracer/flight-recorder identities per engine in one process.
_ENGINE_SEQ = itertools.count()

_M32 = 0xFFFFFFFF
_SEED_MASK = (1 << 63) - 1


def _hash32(x):
    """A 32-bit integer mix (xorshift-multiply, three rounds) of int64
    values in ``[0, 2**32)``; products stay below 2**63, so nothing wraps."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _gumbel(keys, vocab: int):
    """Gumbel noise [B, vocab] (f32) from ``keys`` [B, 2] int64 (seed,
    counter): a hash of (seed, counter, vocab index), nothing else, in
    torch ops (no generator state, so a CUDA graph can capture it)."""
    seed, counter = keys[:, 0], keys[:, 1]
    row = _hash32(_hash32(seed & _M32) ^ ((seed >> 32) & _M32))
    row = _hash32(row ^ _hash32(counter & _M32))
    col = _hash32((torch.arange(vocab, device=keys.device) + 0x9E3779B9) & _M32)
    bits = _hash32(row[:, None] ^ col[None, :])
    u = ((bits >> 9).float() + 0.5) * (2.0 ** -23)  # in (0, 1), exact in f32
    return -torch.log(-torch.log(u))


def _make_keyed_selector(sampling):
    """``select(logits [B, V], keys [B, 2], seen) -> [B]``: argmax when
    ``sampling`` is None, else Gumbel-max over the warped logits with noise
    keyed by ``keys`` (:func:`_gumbel`)."""
    if sampling is None:
        return lambda logits, keys, seen: torch.argmax(logits, dim=-1)
    warp = _make_warper(sampling)

    def select(logits, keys, seen):
        return torch.argmax(warp(logits) + _gumbel(keys, logits.shape[-1]), dim=-1)

    return select


class _TickFlight:
    """One launched-but-unread decode tick: the (slot, request,
    preemption-epoch) entries its mask was built from, which host output
    buffer its tokens land in, the event that marks them there, and the
    launch time. Reconcile commits an entry only if its request is still
    RUNNING *and* its preemption epoch matches (exactly-once emission)."""

    __slots__ = ("entries", "t_dispatch", "buf", "event")

    def __init__(self, entries, t_dispatch, buf, event):
        self.entries = entries          # [(slot, req, req._preempted)]
        self.t_dispatch = t_dispatch
        self.buf = buf
        self.event = event


class _HostEvent:
    """The CPU's stand-in for a CUDA event: work is done when it returns."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _TokenEmitter:
    """Off-thread ``on_token`` delivery: the engine thread enqueues
    (request, token) pairs — and a ``None``-token finish sentinel AFTER a
    retiring request's last token, the drain-on-retire barrier — and one
    daemon thread drains them in order. A raising callback is recorded on
    the request (``_emit_error``); the engine's loop-top sweep turns that
    into the same FAILED retirement an inline callback failure produces.
    The engine bounds the queue per request by flow-controlling streams
    whose ``_emit_pending`` reaches ``max_pending`` (skipped from ticks).
    ``close()`` drains everything already queued, then joins."""

    def __init__(self, max_pending: int):
        self.max_pending = int(max_pending)
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="serving-emitter", daemon=True)
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._closed

    def backlogged(self, req) -> bool:
        return req._emit_pending >= self.max_pending

    def put(self, req, token: int):
        req._emit_pending += 1
        with self._cv:
            self._q.append((req, token))
            self._cv.notify()

    def finish(self, req):
        """Queue the completion sentinel: ``req._complete()`` runs only
        after every callback queued before it has been delivered."""
        with self._cv:
            self._q.append((req, None))
            self._cv.notify()

    def close(self, timeout: Optional[float] = None):
        """Stop accepting work, drain what is queued, join (idempotent)."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout)

    def _drain_loop(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(0.1)
                if not self._q:
                    return  # closed and fully drained
                batch = list(self._q)
                self._q.clear()
            for req, token in batch:
                if token is None:
                    req._complete()
                    continue
                if req._emit_error is None and req.on_token is not None:
                    try:
                        req.on_token(token)
                    except Exception as e:
                        # Error isolation: the engine retires THIS request
                        # FAILED at its next sweep.
                        req._emit_error = e
                req._emit_pending -= 1


def _later(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch serving engine yet "
                               f"(ROADMAP.md, {item})")


class ServingEngine:
    """Slot-based continuous-batching decode service on one device.

    Args:
      model: a cache-threading ``LlamaForCausalLM`` (or a prepared model
        around one), on ``device``.
      max_slots: decode lanes — the fixed batch of the tick.
      max_len: per-slot KV capacity; every request needs
        ``prompt_len + max_new_tokens <= max_len``.
      eos_token_id / do_sample / temperature / top_k / top_p: ENGINE-level
        sampling, fixed in the captured steps. Greedy when
        ``do_sample=False``.
      cache_dtype: KV dtype (default bfloat16, like ``generate``).
      max_queued / priority_policy: the admission queue's bound and order
        (``"default"``: a :class:`~.control.PriorityPolicy`; None: FCFS).
      prefill_chunk: width of the one chunk step (clamped to ``max_len``
        and the position table).
      prefill_chunks_per_tick: chunk calls between two decode ticks,
        alternating the PREFILLING backlog (round-robin) and new arrivals.
      prefix_cache_mb: LRU budget of chunk-aligned prefix blocks (0: off).
      prefix_cache: an external (shareable) :class:`~.scheduler.PrefixCache`
        instead; its blocks restore by copy, also on a paged engine.
      paged / page_size / max_pages: the paged pool (default on; page size
        defaults to the chunk and must divide it; ``max_pages`` usable pages
        besides the scratch page, default enough for every slot at
        ``max_len``).
      accelerator: shares its ``serving_stats`` and makes the engine drain
        on its preemption notice (stop admitting, finish in-flight work,
        cancel the queue).
      stats: a :class:`~.metrics.ServingStats` to record into.
      tracing / trace_capacity / flight_capacity: the span tracer and the
        flight recorder.
      async_ticks: the one-tick-ahead runtime (default); False ticks
        synchronously and runs callbacks inline.
      emission_queue: per-request bound on queued callbacks (async).
      autostart / warmup: start the engine thread in the constructor, and
        push warmup requests through every step (capturing the graphs).
      device: the engine's device (default ``cuda``; raises without a card
        unless ``device="cpu"``). The model's parameters must be on it.
    """

    def __init__(self, model, *, max_slots: int = 4, max_len: int = 256,
                 eos_token_id: Optional[int] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, cache_dtype=None,
                 kv_dtype: Optional[str] = None, weights_dtype: Optional[str] = None,
                 max_queued: int = 64, priority_policy="default",
                 prefill_chunk: Optional[int] = 256, prefill_chunks_per_tick: int = 1,
                 prefix_cache_mb: float = 64.0, adapters=None,
                 paged: Optional[bool] = None, page_size: Optional[int] = None,
                 max_pages: Optional[int] = None, draft_model=None, spec_tokens: int = 4,
                 spec_lookup: Optional[int] = None, tp: Optional[int] = None, mesh=None,
                 devices=None, prefix_cache: Optional[PrefixCache] = None,
                 accelerator=None, stats: Optional[ServingStats] = None,
                 tracing: bool = True, trace_capacity: int = 4096,
                 flight_capacity: int = 256, trace_dir: Optional[str] = None, chaos=None,
                 async_ticks: Optional[bool] = None, emission_queue: int = 256,
                 autostart: bool = True, warmup: bool = True, idle_poll_s: float = 0.005,
                 device=None):
        if draft_model is not None or spec_lookup is not None:
            raise _later("engine speculation (draft_model=, spec_lookup=)", "A5")
        if kv_dtype is not None:
            raise _later(f"kv_dtype={kv_dtype!r} (quantized KV pages)", "A5")
        if prefill_chunk is None:
            raise _later("the monolithic prefill path (prefill_chunk=None)", "A5")
        if adapters is not None or weights_dtype is not None:
            raise _later("adapter banks and weights_dtype", "A6")
        if chaos is not None or trace_dir is not None:
            raise _later("chaos= and trace_dir=", "A7")
        if tp is not None or mesh is not None or devices is not None:
            raise _later("tensor-parallel serving (tp=, mesh=, devices=)", "A8")
        module = getattr(model, "module", model)
        cfg = getattr(module, "config", None)
        if cfg is None or not hasattr(module, "model") or not hasattr(cfg, "window_for"):
            raise TypeError(f"{type(module).__name__} is not a cache-threading "
                            "LlamaForCausalLM; the engine cannot hold its decode state")
        if max_slots < 1 or max_len < 2:
            raise ValueError(f"need max_slots >= 1 and max_len >= 2 (got {max_slots}, {max_len})")
        if int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1 or None (got {prefill_chunk})")
        if prefill_chunks_per_tick < 1:
            raise ValueError(f"prefill_chunks_per_tick must be >= 1 (got {prefill_chunks_per_tick})")
        if prefix_cache_mb < 0:
            raise ValueError(f"prefix_cache_mb must be >= 0 (got {prefix_cache_mb})")
        windows = [cfg.window_for(i) for i in range(cfg.num_hidden_layers)]
        if any(w is not None and w < max_len for w in windows):
            raise _later("sliding-window (ring) KV caches narrower than max_len", "A5")

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        param = next(module.parameters())
        if param.device != self.device:
            raise ValueError(f"the model's parameters are on {param.device}, the engine's "
                             f"device is {self.device}; move the model first")
        self.module = module
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.eos_token_id = eos_token_id
        self._dtype = cache_dtype or torch.bfloat16
        self._sampling = (float(temperature), top_k, top_p) if do_sample else None
        self._select = _make_keyed_selector(self._sampling)
        self._idle_poll_s = float(idle_poll_s)
        self._accelerator = accelerator
        self._on_card = self.device.type == "cuda"

        # The usable position range: max_len capped at the position table.
        self._chunk_limit = min(self.max_len, int(cfg.max_position_embeddings))
        self._chunk = min(int(prefill_chunk), self._chunk_limit)
        # The final chunk may start below its natural i*C offset so its
        # fixed width never writes past the limit (re-running already
        # prefilled positions rewrites the same KV).
        self._chunk_cap = self._chunk_limit - self._chunk
        self._chunks_per_tick = int(prefill_chunks_per_tick)

        if paged is None:
            paged = True
        self._paged = bool(paged)
        if self._paged:
            P = int(page_size) if page_size is not None else self._chunk
            if P < 1 or self._chunk % P != 0:
                raise ValueError(
                    f"page_size ({page_size}) must be >= 1 and divide the prefill chunk "
                    f"({self._chunk}) so chunk writes and cached blocks cover whole pages")
            self._page: Optional[int] = P
        else:
            if page_size is not None or max_pages is not None:
                raise ValueError("page_size=/max_pages= only apply to the paged engine "
                                 "(paged=False keeps dense per-slot rows)")
            self._page = None

        if prefix_cache is not None:
            self._prefix_cache: Optional[PrefixCache] = prefix_cache
            self._alias_cache = False   # external/shared cache: COPY restores
        elif prefix_cache_mb > 0:
            # A paged engine's private cache holds page-id tuples: a hit is
            # a host table write + refcount, eviction returns the pages.
            self._alias_cache = self._paged
            self._prefix_cache = PrefixCache(
                int(prefix_cache_mb * 2 ** 20),
                on_evict=self._on_prefix_evict if self._alias_cache else None)
        else:
            self._prefix_cache = None
            self._alias_cache = False
        #: the chunk step returns the chunk's KV block and a restore step
        #: exists only where the prefix cache restores by copy.
        self._copy_restore = self._prefix_cache is not None and not self._alias_cache
        self._prefilling: collections.deque = collections.deque()

        self._build_state(cfg, max_pages)

        if stats is None and accelerator is not None:
            stats = getattr(accelerator, "serving_stats", None)
        self._stats = stats if stats is not None else ServingStats()
        if priority_policy == "default":
            priority_policy = PriorityPolicy()
        elif priority_policy is not None and not isinstance(priority_policy, PriorityPolicy):
            raise TypeError("priority_policy must be a PriorityPolicy, None (FCFS), or "
                            f"the string 'default' (got {priority_policy!r})")
        self._priority_policy = priority_policy
        self._queue = AdmissionQueue(
            max_queued, rank_fn=priority_policy.rank if priority_policy is not None else None)
        self._slots = SlotScheduler(self.max_slots)

        name = f"engine-{next(_ENGINE_SEQ)}"
        self._tracer = Tracer(capacity=int(trace_capacity), enabled=bool(tracing), name=name)
        self._flight = FlightRecorder(capacity=int(flight_capacity), name=name,
                                      tracer=self._tracer)
        self._capture_watcher = GraphCaptureWatcher(
            on_event=lambda step, seconds: self._flight.record(
                "graph_capture", step=step, seconds=seconds))
        self._graphs = StepGraphs(self.device, self._capture_watcher, self._stream)
        self._postmortem: Optional[dict] = None

        self._accepting = False
        self._stop = False          # hard stop: cancel everything, exit now
        self._drain = False         # finish all accepted work, then exit
        self._abort_queue = False   # preemption: finish running, cancel queued
        self._error: Optional[BaseException] = None
        self._fail_injection: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._warmup_on_start = bool(warmup)
        self._loop_iters = 0
        self._decode_ticks = 0
        self._heartbeat = (0, time.monotonic())
        self._async = True if async_ticks is None else bool(async_ticks)
        if int(emission_queue) < 1:
            raise ValueError(f"emission_queue must be >= 1 (got {emission_queue})")
        self._emission_queue = int(emission_queue)
        self._emitter: Optional[_TokenEmitter] = None
        # Host time blocked on the device since the last reconcile:
        # subtracted from the tick interval to isolate host_us_per_tick.
        self._blocked_s = 0.0
        self._last_complete_t: Optional[float] = None
        self._next_profile_tick = 1
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    # device state and the steps
    # ------------------------------------------------------------------
    def _build_state(self, cfg, max_pages):
        """Allocate the decode state, the steps' static inputs and outputs
        and the host staging buffers."""
        dev, S, C = self.device, self.max_slots, self._chunk
        n_kv, hd, L = cfg.num_key_value_heads, cfg.head_dim, cfg.num_hidden_layers
        itemsize = torch.finfo(self._dtype).bits // 8
        long = dict(dtype=torch.int64, device=dev)
        if self._paged:
            P = self._page
            self._pages_per_slot = -(-self.max_len // P)
            usable = (int(max_pages) if max_pages is not None
                      else self.max_slots * self._pages_per_slot)
            if usable < 1:
                raise ValueError(f"max_pages must be >= 1 (got {max_pages})")
            self._pool = PagePool(usable)
            self._table = np.zeros((S, self._pages_per_slot), np.int64)
            # +1: page 0 is the scratch page inactive writes route to.
            shape = (usable + 1, n_kv, P, hd)
            self._page_bytes = L * 2 * P * n_kv * hd * itemsize
            Np = self._pages_per_slot
        else:
            self._pool = None
            self._table = None
            self._pages_per_slot = 0
            shape = (S, n_kv, self.max_len, hd)
            self._page_bytes = 0
            Np = 0
        # Head-major K/V per layer (models.llama._update_slots_and_attend).
        self._kv = [{"k": torch.zeros(shape, dtype=self._dtype, device=dev),
                     "v": torch.zeros(shape, dtype=self._dtype, device=dev)}
                    for _ in range(L)]
        self._pos = torch.zeros(S, **long)
        self._tok = torch.zeros(S, **long)
        self._done = torch.zeros(S, dtype=torch.bool, device=dev)
        self._seed = torch.zeros(S, **long)
        self._block_shape = (L, 2, n_kv, C, hd)  # a chunk's K/V, head-major
        self._block_bytes = L * 2 * C * n_kv * hd * itemsize

        # Static inputs (one int64 tensor a step, so one copy a call) and
        # outputs. Layouts: decode [active S | table S*Np]; chunk [ids C |
        # slot | offset | true_len | seed | row Np]; restore [slot | offset |
        # true_len] (dense) or [slot | true_len | pages C/P] (paged).
        self._restore_width = 3 if not self._paged else 2 + C // self._page
        self._decode_in = torch.zeros(S + S * Np, **long)
        self._decode_out = torch.zeros(2, S, **long)
        self._chunk_in = torch.zeros(C + 4 + Np, **long)
        self._chunk_out = torch.zeros(1, **long)
        self._restore_in = torch.zeros(self._restore_width, **long)
        if self._copy_restore:
            self._block_out = torch.zeros(self._block_shape, dtype=self._dtype, device=dev)
            self._block_in = torch.zeros(self._block_shape, dtype=self._dtype, device=dev)
        else:
            self._block_out = self._block_in = None

        def host(n):
            return torch.zeros(n, dtype=torch.int64, pin_memory=self._on_card)

        # The tick's staging and outputs are double-buffered (see the
        # module docstring); chunk and restore calls wait on their event
        # before their one buffer is written again.
        self._decode_stage = [host(self._decode_in.numel()) for _ in range(2)]
        self._decode_host_out = [host(2 * S) for _ in range(2)]
        self._chunk_stage = host(self._chunk_in.numel())
        self._chunk_host_out = host(1)
        self._restore_stage = host(self._restore_width)
        if self._on_card:
            self._stream = torch.cuda.Stream(device=dev)
            self._decode_events = [torch.cuda.Event() for _ in range(2)]
            self._chunk_event = torch.cuda.Event()
            self._restore_event = torch.cuda.Event()
            torch.cuda.synchronize(dev)  # the zeros above, before the engine stream uses them
        else:
            self._stream = None
            self._decode_events = [_HostEvent(), _HostEvent()]
            self._chunk_event = self._restore_event = _HostEvent()
        self._tick_buf = 0

    def _layer_caches(self, rows=None, table=None, write=None):
        """Per-layer cache dicts for one step's forward (the layouts of
        ``models.llama._update_slots_and_attend``)."""
        if self._paged:
            return [{"k": c["k"], "v": c["v"], "table": table, "write": write} for c in self._kv]
        return [{"k": c["k"], "v": c["v"], "rows": rows} for c in self._kv]

    def _decode_step(self):
        """One tick over every slot (JAX ``_decode_fn`` / ``_paged_decode_fn``):
        one batched forward at per-slot positions, the KV commit
        unconditional (paged: slots outside the mask write to scratch), then
        ``pos``/``tok``/``done`` advance where the mask is set."""
        S, Np = self.max_slots, self._pages_per_slot
        active = self._decode_in[:S].bool()
        table = self._decode_in[S:].view(S, Np) if self._paged else None
        pos = self._pos
        logits, _ = self.module(self._tok[:, None], cache=self._layer_caches(
            table=table, write=active), cache_pos=pos)
        keys = torch.stack([self._seed, pos + 1], dim=1)  # the drawn token's position
        nxt, done = _next_token(logits[:, -1], keys, None, self._done, self._select,
                                self.eos_token_id, torch.int64)
        self._pos.copy_(torch.where(active, pos + 1, pos))
        self._tok.copy_(torch.where(active, nxt, self._tok))
        self._done.copy_(torch.where(active, done, self._done))
        self._decode_out[0].copy_(nxt)
        self._decode_out[1].copy_(done)

    def _chunk_step(self):
        """One ``[1, C]`` prompt chunk at a tensor offset (JAX
        ``_prefill_chunk_fn`` / ``_paged_prefill_chunk_fn``): writes the
        chunk's KV into the slot (its rows, or its pages), selects the
        candidate first token, pins ``pos[slot] = true_len`` and writes the
        slot's ``tok``/``done``/``seed``; where restores copy, also the
        chunk's KV block."""
        C, Np = self._chunk, self._pages_per_slot
        buf = self._chunk_in
        ids = buf[:C].view(1, C)
        slot, offset, true_len, seed = buf[C:C + 1], buf[C + 1:C + 2], buf[C + 2:C + 3], buf[C + 3:C + 4]
        row = buf[C + 4:].view(1, Np) if self._paged else None
        logits, _ = self.module(ids, cache=self._layer_caches(rows=slot, table=row),
                                cache_pos=offset)
        keys = torch.stack([seed, true_len], dim=1)  # token #1 sits at position true_len
        tok, done = _chunk_prefill_token(logits, keys, self._select, self.eos_token_id,
                                         torch.int64, true_len, offset)
        self._pos.index_copy_(0, slot, true_len)
        self._tok.index_copy_(0, slot, tok)
        self._done.index_copy_(0, slot, done)
        self._seed.index_copy_(0, slot, seed)
        self._chunk_out.copy_(tok)
        if self._block_out is not None:
            at = offset + torch.arange(C, device=buf.device)
            if self._paged:
                index = (row[0, at // self._page], slice(None), at % self._page)
            else:
                index = (slot.expand(C), slice(None), at)
            for i, c in enumerate(self._kv):  # [C, n_kv, hd] -> [n_kv, C, hd]
                self._block_out[i, 0].copy_(c["k"][index].transpose(0, 1))
                self._block_out[i, 1].copy_(c["v"][index].transpose(0, 1))

    def _restore_step(self):
        """Copy one cached chunk block into a slot (JAX ``_restore_prefix_fn``
        / ``_paged_restore_prefix_fn``) and pin ``pos[slot] = true_len``."""
        C, buf, blk = self._chunk, self._restore_in, self._block_in
        slot, G, hd = buf[0:1], blk.shape[2], blk.shape[4]
        if self._paged:
            true_len, pages = buf[1:2], buf[2:]
            shape = (G, C // self._page, self._page, hd)
            for i, c in enumerate(self._kv):  # [n_kv, C, hd] -> [C/P, n_kv, P, hd]
                c["k"].index_copy_(0, pages, blk[i, 0].view(shape).transpose(0, 1))
                c["v"].index_copy_(0, pages, blk[i, 1].view(shape).transpose(0, 1))
        else:
            offset, true_len = buf[1:2], buf[2:3]
            at = offset + torch.arange(C, device=buf.device)
            index = (slot.view(1, 1), torch.arange(G, device=buf.device).view(G, 1),
                     at.view(1, C))
            for i, c in enumerate(self._kv):
                c["k"].index_put_(index, blk[i, 0])
                c["v"].index_put_(index, blk[i, 1])
        self._pos.index_copy_(0, slot, true_len)

    def _launch(self, name: str, step, device_in, stage, parts):
        """Copy ``parts`` ((name, values) pairs, laid end to end) through the
        host buffer ``stage`` into the step's static input ``device_in``,
        then run the step. The parts' names and shapes are its signature."""
        view = stage.numpy()
        at = 0
        for _, values in parts:
            flat = np.asarray(values).reshape(-1)
            view[at:at + flat.size] = flat
            at += flat.size
        if at != view.size:
            raise ValueError(f"step {name!r} takes {view.size} input values, got {at}")
        device_in.copy_(stage, non_blocking=True)
        signature = (name,) + tuple((k, np.shape(v)) for k, v in parts)
        self._graphs.run(name, step, signature)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        """Spawn the engine thread (idempotent) and run warmup traffic."""
        if self._thread is not None:
            return
        self._accepting = True
        self._heartbeat = (self._loop_iters, time.monotonic())
        if self._async and (self._emitter is None or not self._emitter.alive):
            self._emitter = _TokenEmitter(self._emission_queue)
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()
        if self._warmup_on_start:
            self.warmup()

    def warmup(self, timeout: float = 300.0):
        """Run every step once through the normal path, capturing its graph
        on the card: one chunk call and decode ticks, and, when the engine
        restores by copy and a two-chunk prompt fits, two identical
        two-chunk prompts (the second restores). ``ignore_eos`` keeps the
        dummies decoding. Stats, the prefix cache, spans, flight events and
        the capture events are cleared afterwards."""
        req = self.submit(np.zeros((1, 1), np.int32), max_new_tokens=2, seed=0,
                          ignore_eos=True, block=True)
        if not req.wait(timeout):
            raise TimeoutError(f"engine warmup did not finish within {timeout}s")
        self._raise_if_failed(req)
        if self._prefix_cache is not None and self._chunk + 2 <= self._chunk_limit:
            ids = np.zeros((1, self._chunk + 1), np.int32)
            for _ in range(2):
                r = self.submit(ids, max_new_tokens=1, seed=0, ignore_eos=True, block=True)
                if not r.wait(timeout):
                    raise TimeoutError(f"engine warmup did not finish within {timeout}s")
                self._raise_if_failed(r)
        self._stats.reset()
        if self._prefix_cache is not None:
            self._prefix_cache.clear()
        self._tracer.clear()
        self._flight.clear()
        self._next_profile_tick = self._decode_ticks + 1
        self._capture_watcher.reset()

    @staticmethod
    def _raise_if_failed(req):
        if req.status != RequestStatus.COMPLETED:
            raise RuntimeError(f"warmup request {req.status.value}") from req.error

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the engine. ``drain=True`` finishes every accepted request
        (queued and running) first; ``drain=False`` cancels them. Blocks
        for the engine thread (up to ``timeout``)."""
        self._accepting = False
        if drain:
            self._drain = True
        else:
            self._stop = True
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None
        self._queue.close()
        if self._emitter is not None:
            self._emitter.close(timeout)
        if self._error is not None:
            raise RuntimeError("serving engine died") from self._error

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def healthy(self) -> bool:
        """Live and serviceable: thread running, no fatal error, admitting."""
        return self.running and self._error is None and self._accepting

    @property
    def error(self) -> Optional[BaseException]:
        """The fatal error that killed the run loop, if any."""
        return self._error

    @property
    def free_slots(self) -> int:
        return self._slots.free_slots

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def paged(self) -> bool:
        return self._paged

    @property
    def page_size(self) -> Optional[int]:
        return self._page

    @property
    def total_pages(self) -> int:
        return self._pool.num_pages if self._paged else 0

    @property
    def free_pages(self) -> int:
        return self._pool.free_pages if self._paged else 0

    @property
    def heartbeat(self) -> tuple:
        """``(loop_iterations, wall_time)`` published at the top of every
        loop iteration and at every reconcile."""
        return self._heartbeat

    @property
    def decode_ticks(self) -> int:
        return self._decode_ticks

    @property
    def load(self) -> float:
        """``(active slots + queued) / (max_slots + max_queued)``, or the
        pool's used share when higher (paged)."""
        base = ((self._slots.active_slots + len(self._queue))
                / (self.max_slots + self._queue.max_queued))
        if self._paged:
            return max(base, self._pool.used_pages / self._pool.num_pages)
        return base

    def kill(self, error: Optional[BaseException] = None):
        """Make the run loop raise ``error`` at its next iteration, as a
        device fault would: every in-flight and queued request fails."""
        err = error if error is not None else RuntimeError("replica killed by fault injection")
        self._flight.record("kill", error=repr(err))
        self._fail_injection = err

    # ------------------------------------------------------------------
    # submission and observability
    # ------------------------------------------------------------------
    def submit(self, prompt_ids=None, *, request: Optional[Request] = None,
               max_new_tokens: int = 20, seed: Optional[int] = None, rng=None,
               timeout: Optional[float] = None, on_token=None, ignore_eos: bool = False,
               trace_id: Optional[str] = None, priority: Optional[str] = None,
               block: bool = False, block_timeout: Optional[float] = None) -> Request:
        """Enqueue one request; returns its :class:`Request` handle at once.
        Raises :class:`~.scheduler.QueueFull` under backpressure when
        ``block=False``; ``block=True`` waits for queue space (up to
        ``block_timeout``). ``seed`` (or ``rng`` as an int) keys a sampled
        request's draws. A ``request=`` handle must be fresh."""
        if request is None:
            request = Request(prompt_ids, max_new_tokens=max_new_tokens, rng=rng, seed=seed,
                              timeout=timeout, on_token=on_token, ignore_eos=ignore_eos,
                              trace_id=trace_id, priority=priority)
        elif request.status is not RequestStatus.QUEUED or request.submitted_at is not None:
            raise ValueError(
                f"Request handle already used (status {request.status.value}); Request "
                "objects are single-use — build a fresh Request (or pass prompt_ids)")
        if request.adapter is not None:
            raise _later("adapters", "A6")
        for name, value in (("seed", request.seed), ("rng", request.rng)):
            if value is not None and not isinstance(value, (int, np.integer)):
                raise TypeError(f"{name} must be an int for the PyTorch engine (draws are "
                                f"keyed by an integer seed), got {type(value).__name__}")
        if not self._accepting or self._stop or self._drain or self._queue.closed:
            raise RuntimeError("serving engine is not accepting requests "
                               "(not started, shutting down, or preempted)")
        S = request.prompt_ids.shape[1]
        if S < 1:
            raise ValueError("empty prompt")
        if S + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({request.max_new_tokens}) exceeds the "
                f"engine's max_len ({self.max_len}); resize the engine or shorten the request")
        if self._paged:
            # A lone request must always fit the pool (everyone else
            # preempted, the alias cache drained), or admission could wedge.
            need = -(-(S + request.max_new_tokens) // self._page)
            if need > self._pool.num_pages:
                raise ValueError(
                    f"request needs up to {need} KV pages (prompt {S} + max_new_tokens "
                    f"{request.max_new_tokens} at page_size {self._page}) but the pool only "
                    f"has {self._pool.num_pages}; raise max_pages or shorten the request")
        _check_position_bound(self.module, S + request.max_new_tokens)
        if request.trace_id is None:
            request.trace_id = new_trace_id()
        request.submitted_at = time.monotonic()
        try:
            self._queue.put(request, block=block, timeout=block_timeout)
        except QueueFull:
            self._stats.record_reject()
            raise
        except QueueClosed as e:
            raise RuntimeError("serving engine is not accepting requests "
                               "(not started, shutting down, or preempted)") from e
        self._stats.record_submit(len(self._queue))
        if request.priority is not None:
            self._stats.record_priority_request(request.priority)
        args = {"prompt_len": S, "queue_depth": len(self._queue)}
        if request.priority is not None:
            args["priority"] = request.priority
        self._tracer.instant("submit", trace_id=request.trace_id, args=args)
        return request

    def serving_metrics(self) -> dict:
        """Scalar snapshot of the engine's counters (``ServingStats.summary``)."""
        return self._stats.summary()

    @property
    def stats(self) -> ServingStats:
        return self._stats

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        return self._prefix_cache

    @property
    def tracer(self) -> Tracer:
        """This engine's span tracer."""
        return self._tracer

    @property
    def flight_recorder(self) -> FlightRecorder:
        """This engine's black box (last-N structured lifecycle events)."""
        return self._flight

    @property
    def compile_watcher(self) -> GraphCaptureWatcher:
        """The engine's :class:`~accelerate_tpu_torch.utils.profiling.
        GraphCaptureWatcher`, the counterpart of the JAX engine's
        ``CompileWatcher``: after warmup its ``events`` stay empty (no new
        capture on the card, no new step signature on the CPU)."""
        return self._capture_watcher

    @property
    def captured_steps(self) -> list:
        """Names of the steps captured as CUDA graphs (empty on the CPU)."""
        return self._graphs.captured

    def trace_events(self, trace_id: Optional[str] = None) -> list:
        return self._tracer.events(trace_id)

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        """Chrome-trace/Perfetto JSON dict of the buffered spans."""
        return self._tracer.chrome_trace(trace_id)

    def dump_trace(self, path: str, trace_id: Optional[str] = None) -> str:
        return self._tracer.dump(path, trace_id)

    def postmortem(self) -> Optional[dict]:
        """The flight-recorder dump captured when the run loop died."""
        return self._postmortem

    def page_pool_metrics(self) -> dict:
        """Host-side pool snapshot (empty for dense engines)."""
        if not self._paged:
            return {}
        return {
            "page_size": self._page,
            "kv_dtype": None,
            "pages_per_slot": self._pages_per_slot,
            "page_bytes": self._page_bytes,
            "pages_total": self._pool.num_pages,
            "pages_free": self._pool.free_pages,
            "pages_used": self._pool.used_pages,
            "page_allocations": self._pool.allocations,
            "preemptions": self._pool.preemptions,
        }

    def cached_prefix_tokens(self, prompt_ids) -> int:
        """Leading prompt tokens this engine could restore from its prefix
        cache now (host work only; no LRU promotion)."""
        if self._prefix_cache is None:
            return 0
        ids = np.asarray(prompt_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        S, C = int(ids.shape[1]), self._chunk
        restorable = min(S // C, -(-S // C) - 1)
        if restorable < 1:
            return 0
        return self._prefix_cache.longest_prefix(self._prefix_keys(ids, restorable)) * C

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _run(self):
        stream = torch.cuda.stream(self._stream) if self._on_card else contextlib.nullcontext()
        with torch.inference_mode(), stream:
            self._run_loop()

    def _run_loop(self):
        # The one launched-but-unread tick (async mode). Loop shape per
        # iteration: sweeps -> admission -> LAUNCH tick N+1 -> RECONCILE
        # tick N, so host work between the two overlaps tick N+1.
        flight: Optional[_TickFlight] = None
        try:
            while not self._stop:
                self._loop_iters += 1
                self._heartbeat = (self._loop_iters, time.monotonic())
                if self._fail_injection is not None:
                    raise self._fail_injection
                if (self._accelerator is not None
                        and getattr(self._accelerator, "preemption_requested", False)
                        and not (self._drain or self._abort_queue)):
                    # Preemption drain: stop admitting, let in-flight
                    # requests finish, cancel the queue.
                    self._accepting = False
                    self._abort_queue = True
                now = time.monotonic()
                for _, req in self._slots.active():
                    if req._emit_error is not None:
                        self._retire(req, RequestStatus.FAILED, req._emit_error)
                    elif req.cancel_requested:
                        self._retire(req, RequestStatus.CANCELLED)
                    elif req._deadline_passed(now):
                        self._retire(req, RequestStatus.TIMED_OUT)
                if self._abort_queue:
                    for req in self._queue.drain():
                        self._finish_req(req, RequestStatus.CANCELLED)
                        self._stats.record_finish(req.status)
                # Bounded admission: at most chunks_per_tick chunk calls,
                # alternating one continuation of the PREFILLING backlog
                # (round-robin) with one new admission.
                budget = self._chunks_per_tick
                while budget > 0:
                    progressed = False
                    if self._advance_one_prefill():
                        budget -= 1
                        progressed = True
                    if budget > 0 and self._slots.has_free():
                        req = self._queue.get_nowait()
                        if req is not None:
                            progressed = True
                            if self._screen(req, now):
                                budget = self._begin_prefill(req, budget)
                                if budget is None:
                                    break  # paged admission gate: wait for pages
                    if not progressed:
                        break
                running = [(slot, req) for slot, req in self._slots.active()
                           if req.status is RequestStatus.RUNNING]
                if running:
                    if self._async:
                        nxt = self._dispatch(running, ahead=flight is not None)
                        if flight is not None:
                            self._reconcile(flight)
                        flight = nxt
                        if flight is None:
                            time.sleep(min(self._idle_poll_s, 0.001))
                    else:
                        f = self._dispatch(running, ahead=False)
                        if f is not None:
                            self._reconcile(f)
                    continue
                if flight is not None:
                    # The last running streams retired under the in-flight
                    # tick: settle it (its lanes are stray).
                    self._reconcile(flight)
                    flight = None
                    continue
                self._last_complete_t = None   # ITL intervals restart
                if self._slots.active_slots:
                    pass  # prefill-only batch: loop again without idling
                elif self._drain and not len(self._queue):
                    break
                elif self._abort_queue:
                    break
                else:
                    # Idle: block briefly on the queue; the popped request
                    # goes through the same screen as the busy path.
                    req = self._queue.get(timeout=self._idle_poll_s)
                    if req is not None and self._screen(req, time.monotonic()):
                        self._begin_prefill(req, self._chunks_per_tick)
        except BaseException as e:  # engine-fatal: fail everything loudly
            self._error = e
            self._flight.record("fatal", error=repr(e))
            self._postmortem = self._flight.dump()
        finally:
            self._accepting = False
            self._queue.close()
            self._prefilling.clear()
            terminal = (RequestStatus.FAILED if self._error is not None
                        else RequestStatus.CANCELLED)
            for _, req in list(self._slots.active()):
                self._retire(req, terminal, self._error)
            for req in self._queue.drain():
                self._finish_req(req, terminal, self._error)
                self._stats.record_finish(req.status)
            if self._emitter is not None:
                self._emitter.close()

    def _screen(self, req: Request, now: float) -> bool:
        """A request cancelled or past its deadline while queued is
        finished here, never admitted."""
        if req.cancel_requested:
            self._finish_req(req, RequestStatus.CANCELLED)
        elif req._deadline_passed(now):
            self._finish_req(req, RequestStatus.TIMED_OUT)
        else:
            return True
        self._stats.record_finish(req.status)
        return False

    # -- host-side page accounting (engine thread only) -----------------
    def _on_prefix_evict(self, key, value):
        """Alias-cache eviction hook: give back the page refs it held."""
        for pid in value:
            self._pool.decref(int(pid))

    def _release_slot_pages(self, slot: int):
        row = self._table[slot]
        for idx in range(self._pages_per_slot):
            if row[idx]:
                self._pool.decref(int(row[idx]))
        row[:] = 0

    def _alloc_page_into(self, req: Request, idx: int) -> bool:
        """Allocate one page into ``table[req.slot, idx]``; on exhaustion
        first reclaim alias-cache entries LRU-first, then preempt. False
        only when the requester is alone and the pool is still dry."""
        while True:
            pid = self._pool.alloc()
            if pid is not None:
                self._table[req.slot, idx] = pid
                return True
            if self._alias_cache and self._prefix_cache.evict_lru():
                continue
            if not self._preempt_one(req):
                return False

    def _ensure_pages(self, req: Request, upto_pos: int) -> bool:
        """Cover position ``upto_pos`` in the slot's table."""
        row = self._table[req.slot]
        for idx in range(upto_pos // self._page + 1):
            if not row[idx]:
                if not self._alloc_page_into(req, idx):
                    return False
        return True

    def _reclaimable_pages(self) -> int:
        """Alias-cache pages whose only reference is the cache's own."""
        if not self._alias_cache:
            return 0
        return sum(1 for _, val in self._prefix_cache.entries()
                   for pid in val if self._pool.refcount(int(pid)) == 1)

    def _preempt_one(self, requester: Request) -> bool:
        """Pool exhausted: send another stream back to the FRONT of its
        queue class and free its pages (lowest priority first, then the
        newest admitted). It resumes token-exactly later with
        ``prompt + tokens`` as its prompt: the resumed prefill's first
        token is the interrupted stream's next one, sampled ones included
        (draws are keyed by position). False when no other stream holds a
        slot."""
        policy = self._priority_policy

        def victim_key(r):
            rank = policy.rank(getattr(r, "priority", None)) if policy is not None else 0
            return (rank, r.admitted_at or 0.0)

        victim = None
        for _, r in self._slots.active():
            if r is requester:
                continue
            if victim is None or victim_key(r) > victim_key(victim):
                victim = r
        if victim is None:
            return False
        if victim.tokens:
            victim._serve_ids = np.concatenate(
                [victim.prompt_ids, np.asarray([victim.tokens], np.int32)], axis=1)
        self._release_slot_pages(victim.slot)
        self._slots.release(victim.slot)
        victim.slot = None
        try:
            self._prefilling.remove(victim)
        except ValueError:
            pass
        victim.status = RequestStatus.QUEUED
        victim._preempted += 1
        self._pool.preemptions += 1
        self._stats.record_preemption()
        self._flight.record("preemption", trace_id=victim.trace_id,
                            tokens=len(victim.tokens), free_pages=self._pool.free_pages)
        try:
            self._queue.putleft(victim)
        except QueueClosed:
            victim._finish(RequestStatus.CANCELLED)
            self._stats.record_finish(victim.status)
        return True

    # -- chunked prefill ------------------------------------------------
    def _begin_prefill(self, req: Request, budget: int) -> Optional[int]:
        """Assign a slot, restore the longest cached chunk-aligned prefix
        (not billed against the chunk budget) and run the first live chunk.
        Returns the remaining budget, or None when the paged admission gate
        sends the request back to the queue front to wait for pages. The
        engine prefills ``req._serve_ids``: the prompt, or prompt + tokens
        after a preemption."""
        if req._serve_ids is None:
            req._serve_ids = req.prompt_ids
        S = req._serve_ids.shape[1]
        C = self._chunk
        if self._paged:
            need = -(-S // self._page)
            if need > self._pool.free_pages + self._reclaimable_pages():
                self._flight.record("pool_exhausted", trace_id=req.trace_id,
                                    need_pages=need, free_pages=self._pool.free_pages)
                try:
                    self._queue.putleft(req)
                except QueueClosed:
                    req._finish(RequestStatus.CANCELLED)
                    self._stats.record_finish(req.status)
                return None
        req.admitted_at = time.monotonic()
        slot = self._slots.assign(req)
        self._flight.record("admission", trace_id=req.trace_id, slot=slot, prompt_len=S,
                            resumed=bool(req.tokens))
        req.status = RequestStatus.PREFILLING
        seed = req.seed if req.seed is not None else (req.rng if req.rng is not None else 0)
        req._rng_key = int(seed) & _SEED_MASK
        req._chunks_total = -(-S // C)
        req._next_chunk = 0
        req._chunk_keys = None
        if self._prefix_cache is not None:
            n_full = S // C
            if n_full:
                req._chunk_keys = self._prefix_keys(req._serve_ids, n_full)
            # The FINAL chunk always re-runs (blocks hold KV, not the
            # logits the first token needs): at most chunks 0..n-2 restore.
            restorable = min(n_full, req._chunks_total - 1)
            if restorable:
                blocks = self._prefix_cache.match(req._chunk_keys[:restorable])
                restored_bytes = aliased = 0
                Cp = C // self._page if self._paged else 0
                for i, blk in enumerate(blocks):
                    if self._alias_cache:
                        # A tuple of page ids: restoring is a table write +
                        # refcount. The pos pin holds because the first
                        # chunk call below runs before any tick sees the slot.
                        for j, pid in enumerate(blk):
                            self._pool.incref(int(pid))
                            self._table[slot, i * Cp + j] = int(pid)
                        restored_bytes += len(blk) * self._page_bytes
                        aliased += 1
                        continue
                    if self._paged:
                        if not all(self._alloc_page_into(req, i * Cp + j) for j in range(Cp)):
                            raise RuntimeError(
                                "page pool exhausted during prefix restore with no "
                                "preemptable stream — the submit page bound should make "
                                "this impossible")
                        parts = [("slot", [slot]), ("true_len", [S]),
                                 ("pages", self._table[slot, i * Cp:(i + 1) * Cp])]
                    else:
                        parts = [("slot", [slot]), ("offset", [i * C]), ("true_len", [S])]
                    self._restore_event.synchronize()  # its staging buffer is free again
                    self._block_in.copy_(blk, non_blocking=True)
                    self._launch("restore", self._restore_step, self._restore_in,
                                 self._restore_stage, parts)
                    self._restore_event.record(self._stream)
                    restored_bytes += self._block_bytes
                self._stats.record_prefix(looked_up=restorable, hit=len(blocks),
                                          bytes_restored=restored_bytes, aliased=aliased)
                if blocks:
                    self._tracer.instant("prefix_hit", trace_id=req.trace_id,
                                         args={"chunks": len(blocks), "aliased": aliased,
                                               "bytes": restored_bytes})
                req._next_chunk = len(blocks)
        self._prefilling.append(req)
        self._run_chunk(req)
        return budget - 1

    def _prefix_keys(self, prompt_ids, n_full: int) -> list:
        """Hash-chain digests of the prompt's full chunks: chunk i's key
        covers tokens ``[0, (i+1)*C)`` (each digest folds in the previous)."""
        flat = np.ascontiguousarray(prompt_ids[0], np.int32)
        C = self._chunk
        keys, prev = [], b"chunk:%d" % C
        for i in range(n_full):
            prev = hashlib.blake2b(prev + flat[i * C:(i + 1) * C].tobytes(),
                                   digest_size=16).digest()
            keys.append(prev)
        return keys

    def _advance_one_prefill(self) -> bool:
        """Run ONE chunk for the oldest live PREFILLING entry (round-robin:
        it requeues behind newer ones). False when none is left."""
        while self._prefilling:
            req = self._prefilling.popleft()
            if req.status is not RequestStatus.PREFILLING:
                continue
            self._run_chunk(req)
            if req.status is RequestStatus.PREFILLING:
                self._prefilling.append(req)
            return True
        return False

    def _run_chunk(self, req: Request):
        """One chunk call at the request's frontier; the final chunk's
        offset is pulled back to stay in bounds. Full chunks feed the
        prefix cache (page ids, or the block the step returned)."""
        i = req._next_chunk
        C = self._chunk
        S = req._serve_ids.shape[1]
        final = i == req._chunks_total - 1
        offset = min(i * C, self._chunk_cap) if final else i * C
        ids_c = req._serve_ids[0, offset:offset + C]
        if ids_c.shape[0] < C:
            ids_c = np.pad(ids_c, (0, C - ids_c.shape[0]), mode="edge")
        t0 = time.monotonic()
        parts = [("ids", ids_c), ("slot", [req.slot]), ("offset", [offset]),
                 ("true_len", [S]), ("seed", [req._rng_key])]
        if self._paged:
            # Cover the chunk's whole write span (edge-pad tail included).
            if not self._ensure_pages(req, offset + C - 1):
                raise RuntimeError("page pool exhausted mid-prefill with no preemptable "
                                   "stream — the submit page bound should make this impossible")
            parts.append(("row", self._table[req.slot]))
        self._launch("chunk", self._chunk_step, self._chunk_in, self._chunk_stage, parts)
        self._chunk_host_out.copy_(self._chunk_out, non_blocking=True)
        self._chunk_event.record(self._stream)
        tb = time.monotonic()
        self._chunk_event.synchronize()  # honest chunk timing, paced launches
        self._blocked_s += time.monotonic() - tb
        tok = int(self._chunk_host_out[0])
        dt_ms = (time.monotonic() - t0) * 1e3
        backlog = sum(1 for r in self._prefilling if r.status is RequestStatus.PREFILLING)
        self._stats.record_prefill_chunk(dt_ms, backlog=backlog)
        self._tracer.emit("prefill_chunk", t0, dt_ms / 1e3, trace_id=req.trace_id,
                          args={"chunk": i, "of": req._chunks_total, "offset": offset,
                                "slot": req.slot, "backlog": backlog})
        if (self._prefix_cache is not None and req._chunk_keys is not None
                and offset == i * C and offset + C <= S):
            if self._alias_cache:
                # The entry is the chunk's page ids: the cache takes its own
                # reference on each (returned on eviction); a rejected or
                # duplicate put hands them straight back.
                p0, Cp = offset // self._page, C // self._page
                pids = tuple(int(x) for x in self._table[req.slot, p0:p0 + Cp])
                for pid in pids:
                    self._pool.incref(pid)
                if not self._prefix_cache.put(req._chunk_keys[i], pids,
                                              nbytes=Cp * self._page_bytes):
                    for pid in pids:
                        self._pool.decref(pid)
            else:
                self._prefix_cache.put(req._chunk_keys[i], self._block_out.clone(),
                                       nbytes=self._block_bytes)
            self._stats.record_prefix_cache_size(self._prefix_cache.nbytes,
                                                 len(self._prefix_cache))
        req._next_chunk = i + 1
        if final:
            self._finish_prefill(req, tok)

    def _finish_prefill(self, req: Request, token: int):
        """Prompt fully in KV: the request starts decoding. TTFT is stamped
        on the FIRST completion only (a resumed request has its record)."""
        req.status = RequestStatus.RUNNING
        now = time.monotonic()
        if req.first_token_at is None:
            req.first_token_at = now
            self._stats.record_admit(queue_wait_ms=(req.admitted_at - req.submitted_at) * 1e3,
                                     ttft_ms=(now - req.submitted_at) * 1e3)
            self._tracer.emit("queue_wait", req.submitted_at, req.admitted_at - req.submitted_at,
                              trace_id=req.trace_id, args={"slot": req.slot})
            self._tracer.instant("first_token", trace_id=req.trace_id,
                                 args={"ttft_ms": round((now - req.submitted_at) * 1e3, 3)})
        # Host mirror of the device write position: _pos_base + len(tokens)
        # is the slot's next KV write position.
        req._pos_base = req._serve_ids.shape[1] - len(req.tokens) - 1
        if self._commit_token(req, token):
            if (len(req.tokens) >= req.max_new_tokens
                    or (not req.ignore_eos and self.eos_token_id is not None
                        and token == self.eos_token_id)):
                self._retire(req, RequestStatus.COMPLETED)

    # -- decode ticks -----------------------------------------------------
    def _dispatch(self, running, ahead: bool) -> Optional[_TickFlight]:
        """Launch one decode tick and return its flight WITHOUT waiting.
        PREFILLING slots ride along in the fixed-shape forward but are
        masked out of every state advance. Paged engines first cover every
        launched slot's write position (allocating, and preempting on
        exhaustion, here) and stage a snapshot of the page table.

        ``ahead=True`` (one tick in flight): a stream within one token of
        its budget sits out (it retires at the in-flight tick), and page
        coverage reaches one position past the stale frontier."""
        live = []
        for slot, req in running:
            if ahead and req.max_new_tokens - len(req.tokens) <= 1:
                continue  # retires at the in-flight tick (position bound)
            if (self._emitter is not None and req.on_token is not None
                    and self._emitter.backlogged(req)):
                self._stats.record_emission_stall()
                continue
            live.append((slot, req))
        if self._paged:
            for slot, req in live:
                if req.status is not RequestStatus.RUNNING:
                    continue  # preempted by an earlier slot's allocation
                upto = req._pos_base + len(req.tokens) + (1 if ahead else 0)
                if not self._ensure_pages(req, upto):
                    raise RuntimeError("page pool exhausted at a tick with no preemptable "
                                       "stream — the submit page bound should make this "
                                       "impossible")
            live = [(s, r) for s, r in live if r.status is RequestStatus.RUNNING]
        if not live:
            return None
        mask = np.zeros((self.max_slots,), np.int64)
        for slot, _ in live:
            mask[slot] = 1
        parts = [("active", mask)]
        if self._paged:
            parts.append(("table", self._table))
        t0 = time.monotonic()
        buf = self._tick_buf
        self._tick_buf ^= 1
        self._launch("decode", self._decode_step, self._decode_in, self._decode_stage[buf],
                     parts)
        self._decode_host_out[buf].copy_(self._decode_out.view(-1), non_blocking=True)
        event = self._decode_events[buf]
        event.record(self._stream)
        return _TickFlight([(slot, req, req._preempted) for slot, req in live], t0, buf, event)

    def _reconcile(self, flight: _TickFlight):
        """Settle a launched tick: wait for its tokens (the one device sync
        a tick), then commit/retire on the host. An entry whose request is
        no longer RUNNING, or whose preemption epoch moved, is a stray
        lane: its token is discarded (exactly-once emission).

        ``itl`` is the device-complete to device-complete interval;
        ``host_us_per_tick`` is that interval minus every blocked wait
        since the previous reconcile."""
        tb = time.monotonic()
        flight.event.synchronize()
        out = self._decode_host_out[flight.buf].numpy()
        toks, dones = out[:self.max_slots].copy(), out[self.max_slots:].astype(bool)
        t1 = time.monotonic()
        self._blocked_s += t1 - tb
        self._heartbeat = (self._loop_iters, t1)
        prev = self._last_complete_t
        interval = t1 - (prev if prev is not None else flight.t_dispatch)
        self._last_complete_t = t1
        host_s = max(0.0, interval - self._blocked_s)
        self._blocked_s = 0.0
        committed = 0
        for slot, req, epoch in flight.entries:
            if req.status is not RequestStatus.RUNNING or req._preempted != epoch:
                continue  # stray lane: retired/preempted since launch
            if not self._commit_token(req, int(toks[slot])):
                continue  # callback failed; slot already freed
            committed += 1
            if (len(req.tokens) >= req.max_new_tokens
                    or (not req.ignore_eos and bool(dones[slot]))):
                self._retire(req, RequestStatus.COMPLETED)
        self._decode_ticks += 1
        self._stats.record_tick(active_slots=len(flight.entries), committed_tokens=committed,
                                max_slots=self.max_slots, seconds=interval,
                                host_us=host_s * 1e6)
        tracer = self._tracer
        if tracer.enabled:
            tracer.emit("decode_tick", flight.t_dispatch, t1 - flight.t_dispatch,
                        args={"active": len(flight.entries), "committed": committed,
                              "host_us": round(host_s * 1e6, 1)})
            for slot, req, _ in flight.entries:
                tracer.emit("itl", t1 - interval, interval, trace_id=req.trace_id,
                            args={"slot": slot, "token": len(req.tokens)})
        if self._decode_ticks >= self._next_profile_tick:
            self._next_profile_tick = self._decode_ticks + 128
            self._flight.record("tick_profile", tick=self._decode_ticks,
                                itl_ms=round(interval * 1e3, 3),
                                host_us=round(host_s * 1e6, 1), active=len(flight.entries))
        if self._paged:
            self._stats.record_pages(self._pool.free_pages, self._pool.used_pages,
                                     self._pool.num_pages, freed_total=self._pool.frees)

    def _commit_token(self, req: Request, token: int) -> bool:
        """Append + stream one token (queued on the emitter in async mode,
        inline otherwise, where a raising ``on_token`` fails only its own
        request). False when the request was retired instead."""
        if req._emit_error is not None:
            self._retire(req, RequestStatus.FAILED, req._emit_error)
            return False
        req.tokens.append(token)
        if req.on_token is not None:
            if self._emitter is not None:
                self._emitter.put(req, token)
            else:
                try:
                    req.on_token(token)
                except Exception as e:
                    self._retire(req, RequestStatus.FAILED, e)
                    return False
        return True

    def _finish_req(self, req: Request, status: RequestStatus,
                    error: Optional[BaseException] = None):
        """Terminal transition; a streaming request's observable completion
        waits behind its buffered callbacks in async mode."""
        if self._emitter is not None and req.on_token is not None:
            if req._finish(status, error, defer=True):
                self._emitter.finish(req)
        else:
            req._finish(status, error)

    def _retire(self, req: Request, status: RequestStatus,
                error: Optional[BaseException] = None):
        if req.slot is not None:
            if self._paged:
                self._release_slot_pages(req.slot)
            self._slots.release(req.slot)
        if req.priority is not None:
            self._stats.record_priority_tokens(req.priority, len(req.tokens))
        self._finish_req(req, status, error)
        self._stats.record_finish(req.status)
        retire_args = {"status": req.status.value, "tokens": len(req.tokens)}
        if req.priority is not None:
            retire_args["priority"] = req.priority
        self._tracer.instant("retire", trace_id=req.trace_id, args=retire_args)
        if req.status is RequestStatus.FAILED and error is not self._error:
            self._flight.record("request_failed", trace_id=req.trace_id, error=repr(error))
