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

Speculation (``draft_model=`` or ``spec_lookup=``, paged engines): the
tick is a ``spec`` step instead of ``decode``. It takes ``spec_tokens``
proposals a slot, from K draft-model steps through the slot's draft pages
(the same pool's ids through their own table, at the draft's widths) or
from the host's prompt lookup (passed in the step's input), and verifies
them in one ``[max_slots, K+1]`` forward; greedy streams are the decode
tick's, sampled ones follow the same law with the same position-keyed
noise (:func:`generation.speculative_emit_keyed`). A draft engine's chunk
step also prefills the draft, and a ``draft_chunk`` step rebuilds a
prefix-restored span's draft K/V. A lookup engine reconciles a tick before
drafting the next (its proposals anchor on the newest token).

int8 KV pages (``kv_dtype="int8"``): one f32 scale per page and layer leaf.
A step gathers its rows' views dequantized, the forward writes and attends
them at full precision, and every page the step wrote is requantized whole
from its view (JAX ``:1313-1378``).

``prefill_chunk=None`` (dense only): a prompt is edge-padded to its
128-bucket and prefilled whole by that bucket's step, captured at the
bucket's first use. Sliding-window models serve on paged engines: where
every layer has the same window, pages wholly behind it are freed as a
stream advances. Adapters (``adapters=``, an
:class:`~accelerate_tpu_torch.adapters.AdapterBank`): each slot's bank row
is state of the steps, gathered inside them; ``weights_dtype="int8"``
serves a copy of the model with int8 base projections
(:func:`~accelerate_tpu_torch.adapters.quantize_base_weights`).

The engine runs its own thread, which sets ``torch.inference_mode`` and
the engine's CUDA stream for itself and captures the graphs at warmup.

Fleet hooks (JAX ``:1006-1031``, ``:2020-2053``): a
:class:`~.chaos.ChaosSchedule` (``chaos=``) runs at the top of every loop
iteration, before the heartbeat; a chaos wedge sleeps inside the next
reconcile barrier, before the tick's sync, publishing no heartbeat;
``trace_dir=`` dumps ``<name>-trace.json`` and ``<name>-flight.json`` on
death and on shutdown; :meth:`page_drain_rate` and
:meth:`projected_page_deficit` feed the router's and the autoscaler's
pressure signals. A run loop that dies waits for its stream before it
retires its requests, so no replay of a dead engine is still running when
they fail over.

Tensor-parallel slices (``tp=``, ``mesh=``, ``devices=``, or a model
prepared under a tp-only mesh; JAX ``:505-522``, ``:880-935``,
``:1049-1100``): the engine serves on one :mod:`.mesh_exec` slice. Its
model is this process's Megatron shard, its K/V (slot rows or page pool)
holds this process's heads (or its slice of ``head_dim``), every per-slot
row and page scale stays whole, a draft model and its pool stay whole, and
an int8 page's scale is the MAX of the slice's amaxes. Above ``tp=1`` the
slice runs one process per tp index: the engine on process 0 is the leader
(everything above), the one on each other process a follower, whose thread
runs each step the leader's channel hands it; construction is a collective
(every process builds the same engines in the same order). The chunk step
gathers a copy-restore block whole, and the leader keeps it on the host
(slice-portable), as at ``tp=1``. Monolithic prefill is refused, as in the
JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import itertools
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..adapters.quantize import quantize_base_weights
from ..adapters.registry import AdapterBank
from ..generation import (
    _bucket128,
    _check_position_bound,
    _chunk_prefill_token,
    _make_keyed_selector,
    _make_warper,
    _next_token,
    speculative_emit_keyed,
)
from ..observability import FlightRecorder, Tracer, new_trace_id
from ..utils.device import resolve_device
from ..utils.profiling import GraphCaptureWatcher
from .control import PriorityPolicy
from .graphs import StepGraphs
from .mesh_exec import (
    BANK_ROW,
    STEP,
    STOP,
    SliceExec,
    SliceFollowerError,
    SliceMesh,
    SlicePlan,
    shard_for_serving,
    validate_serving_mesh,
)
from .metrics import ServingStats
from .request import Request, RequestStatus
from .scheduler import AdmissionQueue, PagePool, PrefixCache, QueueClosed, QueueFull, SlotScheduler

__all__ = ["ServingEngine"]

#: distinct tracer/flight-recorder identities per engine in one process.
_ENGINE_SEQ = itertools.count()

_SEED_MASK = (1 << 63) - 1

#: The steps a slice's channel names, by code.
_STEP_NAMES = ("decode", "spec", "chunk", "restore", "draft_chunk")


class _TickFlight:
    """One launched-but-unread decode tick: the (slot, request,
    preemption-epoch) entries its mask was built from, which host output
    buffer its tokens land in, the event that marks them there, and the
    launch time. Reconcile commits an entry only if its request is still
    RUNNING *and* its preemption epoch matches (exactly-once emission)."""

    __slots__ = ("entries", "t_dispatch", "buf", "event", "lookup_hits")

    def __init__(self, entries, t_dispatch, buf, event, lookup_hits=0):
        self.entries = entries          # [(slot, req, req._preempted)]
        self.t_dispatch = t_dispatch
        self.buf = buf
        self.event = event
        self.lookup_hits = lookup_hits  # prompt-lookup slots whose n-gram matched


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


def _monolithic_refused():
    return NotImplementedError(
        "the monolithic prefill path (prefill_chunk=None) is single-chip only; mesh-sliced "
        "engines require chunked prefill (pass a prefill_chunk width)")


def _cached_lm(model, role: str):
    """The cache-threading ``LlamaForCausalLM`` under ``model`` (a prepared
    model or the module itself); NotImplementedError for an encoder-decoder
    model (the JAX engine's refusal), TypeError for anything else."""
    module = getattr(model, "module", model)
    if hasattr(module, "init_decode_cache"):
        raise NotImplementedError("ServingEngine serves decoder-only cache-threading modules; "
                                  "encoder-decoder models go through seq2seq_generate")
    cfg = getattr(module, "config", None)
    if cfg is None or not hasattr(module, "model") or not hasattr(cfg, "window_for"):
        raise TypeError(f"{type(module).__name__} ({role}) is not a cache-threading "
                        "LlamaForCausalLM; the engine cannot hold its decode state")
    return module


def _windows(cfg) -> list:
    """Each layer's sliding window (None = full attention)."""
    return [cfg.window_for(i) for i in range(cfg.num_hidden_layers)]


def _quant_page(blocks, group=None):
    """int8 pages and their f32 scales from f32 page blocks [n, ...] (JAX
    ``_quant_page`` ``engine.py:1313``, per block): a symmetric absmax over
    the whole block with a 1e-6 floor, ``/ 127``, round half to even. On a
    slice (``group``, its tp group) each process holds its share of every
    block: the amax is the MAX over the slice, the whole logical page's."""
    flat = blocks.reshape(blocks.shape[0], -1)
    amax = flat.abs().amax(dim=1)
    if group is not None:
        amax = group.all_reduce(amax.contiguous(), "max")
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127).to(torch.int8)
    return q.view(blocks.shape), scale


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
      kv_dtype: ``"int8"`` stores the paged KV pool as int8 with one f32
        scale per page and layer leaf (paged only); None keeps
        ``cache_dtype``.
      weights_dtype: ``"int8"`` serves the model's base projections as
        per-output-channel int8, dequantized before each product; adapters
        stay full precision.
      max_queued / priority_policy: the admission queue's bound and order
        (``"default"``: a :class:`~.control.PriorityPolicy`; None: FCFS).
      prefill_chunk: width of the one chunk step (clamped to ``max_len``
        and the position table); None prefills each prompt whole, one step
        per 128-bucket of prompt length (dense engines only).
      prefill_chunks_per_tick: chunk calls between two decode ticks,
        alternating the PREFILLING backlog (round-robin) and new arrivals.
      prefix_cache_mb: LRU budget of chunk-aligned prefix blocks (0: off).
      prefix_cache: an external (shareable) :class:`~.scheduler.PrefixCache`
        instead; its blocks restore by copy, also on a paged engine.
      adapters: an :class:`~accelerate_tpu_torch.adapters.AdapterBank` of
        LoRA adapters on the engine's device; a request's ``adapter`` names
        one (None: bank row 0, the base model).
      paged / page_size / max_pages: the paged pool (default on with
        chunked prefill; page size
        defaults to the chunk and must divide it; ``max_pages`` usable pages
        besides the scratch page, default enough for every slot at
        ``max_len``).
      draft_model / spec_tokens: speculative decoding with a draft
        ``LlamaForCausalLM`` of the same vocabulary, ``spec_tokens``
        proposals a tick (paged only; its pages come from the same pool).
      spec_lookup: n-gram width of draft-free prompt-lookup speculation
        (exclusive with ``draft_model``).
      tp / mesh / devices: serve on a tensor-parallel slice
        (:mod:`.mesh_exec`): ``tp=`` carves one slice of that width from
        ``devices`` (default: every visible card; ``["cpu"] * tp`` under
        ``device="cpu"``), ``mesh=`` names a tp-only mesh (a
        :class:`~.mesh_exec.SliceMesh` of a :class:`~.mesh_exec.SlicePlan`).
        Without them, a model prepared under a tp-only mesh (the
        accelerator's, or its own layout's) serves sliced, and one whose
        parameters are split over another axis raises.
      accelerator: shares its ``serving_stats`` and makes the engine drain
        on its preemption notice (stop admitting, finish in-flight work,
        cancel the queue).
      stats: a :class:`~.metrics.ServingStats` to record into.
      tracing / trace_capacity / flight_capacity: the span tracer and the
        flight recorder.
      trace_dir: when set, ``<name>-trace.json`` and ``<name>-flight.json``
        are written there on shutdown or death (``serve --trace-dir``).
      chaos: a :class:`~.chaos.ChaosSchedule` of scripted faults (kill,
        hang, slow ticks, a wedge inside a launched tick) keyed on decode
        ticks, applied from the run loop.
      async_ticks: the one-tick-ahead runtime (default); False ticks
        synchronously and runs callbacks inline.
      emission_queue: per-request bound on queued callbacks (async).
      autostart / warmup: start the engine thread in the constructor, and
        push warmup requests through every step (capturing the graphs).
      device: the engine's device (default ``cuda``; raises without a card
        unless ``device="cpu"``). The model's parameters must be on it.
    """

    #: Construction-time switch of :attr:`tick_log` (tests).
    record_ticks = False

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
        module = _cached_lm(model, "model")
        cfg = module.config
        if max_slots < 1 or max_len < 2:
            raise ValueError(f"need max_slots >= 1 and max_len >= 2 (got {max_slots}, {max_len})")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1 or None (got {prefill_chunk})")
        if prefill_chunks_per_tick < 1:
            raise ValueError(f"prefill_chunks_per_tick must be >= 1 (got {prefill_chunks_per_tick})")
        if prefix_cache_mb < 0:
            raise ValueError(f"prefix_cache_mb must be >= 0 (got {prefix_cache_mb})")

        if prefill_chunk is None and (tp is not None or mesh is not None):
            raise _monolithic_refused()
        serving_mesh = self._resolve_serving_mesh(tp, mesh, devices, device, accelerator,
                                                  model, module)
        #: the engine's slice mesh when it serves on a slice, else None.
        self.mesh = serving_mesh
        self._exec: Optional[SliceExec] = (SliceExec(serving_mesh) if serving_mesh is not None
                                           else None)
        #: tensor-parallel width of this engine's slice (1: one device).
        self.tp = self._exec.tp if self._exec is not None else 1
        #: the slice's channel (above tp=1), and this engine's role on it.
        self._channel = self._exec.channel if self._exec is not None else None
        self.leader = self._exec is None or self._exec.leader
        self._channel_closed = False
        self._slice_group = self._exec.group if self._exec is not None else None
        if serving_mesh is not None and prefill_chunk is None:
            raise _monolithic_refused()
        # Above tp=1 construction is a collective: every process of the
        # slice ends it with a handshake, and one's failure raises on all.
        try:
            if self._exec is not None:
                self.device = self._exec.device
                if device is not None and torch.device(device).type != self.device.type:
                    raise ValueError(f"device={device!r} disagrees with the slice's device "
                                     f"{self.device}")
            else:
                self.device = resolve_device(device)
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            if self._exec is None:
                param = next(module.parameters())
                if param.device != self.device:
                    raise ValueError(f"the model's parameters are on {param.device}, the engine's "
                                     f"device is {self.device}; move the model first")
            self.max_slots = int(max_slots)
            self.max_len = int(max_len)
            self.eos_token_id = eos_token_id
            self._dtype = cache_dtype or torch.bfloat16
            self._sampling = (float(temperature), top_k, top_p) if do_sample else None
            self._select = _make_keyed_selector(self._sampling)
            # The sampling target's warper, shared by the speculative verify.
            self._warp = _make_warper(self._sampling) if self._sampling is not None else None
            self._idle_poll_s = float(idle_poll_s)
            self._accelerator = accelerator
            self._on_card = self.device.type == "cuda"

            # The usable position range: max_len capped at the position table.
            self._chunk_limit = min(self.max_len, int(cfg.max_position_embeddings))
            if prefill_chunk is None:
                # Monolithic prefill: one step per 128-bucket of prompt length.
                self._chunk: Optional[int] = None
                self._chunk_cap = 0
            else:
                self._chunk = min(int(prefill_chunk), self._chunk_limit)
                # The final chunk may start below its natural i*C offset so its
                # fixed width never writes past the limit (re-running already
                # prefilled positions rewrites the same KV).
                self._chunk_cap = self._chunk_limit - self._chunk
            self._chunks_per_tick = int(prefill_chunks_per_tick)

            if paged is None:
                paged = self._chunk is not None
            if paged and self._chunk is None:
                raise ValueError("paged=True requires chunked prefill (pages are allocated at "
                                 "chunk granularity); pass a prefill_chunk width")
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

            # Quantized serving: int8 KV pages (one f32 scale per page and
            # leaf) need the paged pool; int8 base weights any layout.
            if kv_dtype not in (None, "int8"):
                raise ValueError(f"kv_dtype must be None or 'int8' (got {kv_dtype!r})")
            if weights_dtype not in (None, "int8"):
                raise ValueError(f"weights_dtype must be None or 'int8' (got {weights_dtype!r})")
            if kv_dtype is not None and not self._paged:
                raise ValueError("kv_dtype='int8' requires the paged engine (per-page scales are "
                                 "indexed by page id); pass paged=True or drop kv_dtype")
            self._kv_dtype = kv_dtype
            self._weights_dtype = weights_dtype

            # Speculation: a draft model or host prompt lookup proposes
            # spec_tokens tokens a tick, one [max_slots, K+1] verify checks them.
            if draft_model is not None and spec_lookup is not None:
                raise ValueError("draft_model= and spec_lookup= are mutually exclusive: one engine "
                                 "drafts either with a model or by prompt lookup")
            self._draft = None
            self._spec_lookup: Optional[int] = None
            self._spec_mode: Optional[str] = None
            self._spec_k: Optional[int] = None
            if draft_model is not None or spec_lookup is not None:
                if not self._paged:
                    raise NotImplementedError("speculative decoding requires the paged engine "
                                              "(paged=True)")
                if int(spec_tokens) < 1:
                    raise ValueError(f"spec_tokens must be >= 1 (got {spec_tokens})")
                self._spec_k = int(spec_tokens)
            if draft_model is not None:
                draft = _cached_lm(draft_model, "draft_model")
                if draft.config.vocab_size != cfg.vocab_size:
                    raise ValueError(f"draft vocab ({draft.config.vocab_size}) != target vocab "
                                     f"({cfg.vocab_size}); acceptance compares token ids, so the "
                                     "vocabularies must match")
                if next(draft.parameters()).device != self.device:
                    raise ValueError("the draft model's parameters are not on the engine's device")
                span = self.max_len + self._spec_k
                if any(w is not None and w < span for w in _windows(draft.config)):
                    raise NotImplementedError("the draft model's KV cache must be linear at "
                                              "max_len + spec_tokens (raise its sliding window)")
                self._draft = draft
                self._spec_mode = "draft"
            elif spec_lookup is not None:
                if int(spec_lookup) < 1:
                    raise ValueError(f"spec_lookup (n-gram width) must be >= 1 (got {spec_lookup})")
                self._spec_lookup = int(spec_lookup)
                self._spec_mode = "lookup"

            self._external_cache = prefix_cache is not None
            if prefix_cache is not None:
                if self._chunk is None:
                    raise ValueError("prefix_cache= requires chunked prefill (prefill_chunk=None "
                                     "has no chunk-aligned blocks)")
                self._prefix_cache: Optional[PrefixCache] = prefix_cache
                self._alias_cache = False   # external/shared cache: COPY restores
            elif self._chunk is not None and prefix_cache_mb > 0:
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

            # Sliding-window (ring) models: the paged view is a linear cache the
            # attention masks by the window; dense slot rows cannot rotate.
            windows = _windows(cfg)
            has_ring = any(w is not None and w < self.max_len for w in windows)
            if has_ring and not self._paged:
                raise NotImplementedError(
                    "sliding-window (ring) KV caches need the paged engine (paged=True frees "
                    "out-of-window pages); the dense slot layout cannot rotate them, or set the "
                    "config's window >= max_len")
            #: the window when pages wholly out of it may be freed: paged and
            #: every layer windowed alike (mixed local/global stacks keep all
            #: their pages).
            self._page_window: Optional[int] = (
                int(windows[0]) if self._paged and has_ring and len(set(windows)) == 1 else None)

            if adapters is not None:
                if not isinstance(adapters, AdapterBank):
                    raise TypeError("adapters must be an AdapterBank "
                                    f"(got {type(adapters).__name__})")
            self._adapters = adapters
            # int8 base weights: a copy of the model whose projections keep
            # int8 at rest (the caller's model is left as it was); adapters
            # stay full precision in the bank. On a slice: this process's shard
            # of the model (of its int8 copy), shared by the slices on one
            # device.
            if self._exec is None:
                self.module = module if weights_dtype is None else quantize_base_weights(module)
            else:
                source, config = module, None
                layout = getattr(model, "layout", None) or getattr(module, "_sharded_layout", None)
                if layout is not None and any(layout.splits.values()):
                    # A prepared model holds its training chunks: put it
                    # together once (a collective over its mesh), then cut it.
                    source, config = layout.full_state_dict(module), cfg
                self.module = shard_for_serving(source, self._exec, config=config,
                                                weights_dtype=weights_dtype)
                param = next(self.module.parameters())
                if param.device != self.device:
                    raise ValueError(f"the model's parameters are on {param.device}, the slice's "
                                     f"device is {self.device}; move the model first")
                if adapters is not None:
                    adapters.place(self._exec)
                    if self._channel is not None and self.leader:
                        adapters.row_listener = self._send_bank_row
            # This process's K/V widths: on a slice the heads axis (the K/V
            # heads, else head_dim) holds its share.
            n_kv, hd = cfg.num_key_value_heads, cfg.head_dim
            self._kv_axis = (None if self._exec is None
                             else self._exec.heads_axis((1, self.max_len, n_kv, hd), 1))
            if self.tp > 1 and self._kv_axis is None:
                raise NotImplementedError(
                    f"neither the K/V heads ({n_kv}) nor head_dim ({hd}) split over tp={self.tp}")
            self._kv_heads = n_kv // self.tp if self._kv_axis == 2 else n_kv
            self._kv_hd = hd // self.tp if self._kv_axis == 3 else hd

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
            # Liveness and fault injection (supervisor.py, chaos.py): the loop
            # publishes a heartbeat each iteration unless a chaos hang froze
            # it; a chaos wedge sleeps ``_wedge_s`` inside the next reconcile.
            self._chaos = chaos
            self._trace_dir = trace_dir
            self._loop_iters = 0
            self._decode_ticks = 0
            self._heartbeat = (0, time.monotonic())
            self._heartbeat_frozen = False
            self._wedge_s = 0.0
            # (time, pages freed so far) a tick: the page_drain_rate samples.
            self._drain_samples: collections.deque = collections.deque(maxlen=256)
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
            #: every tick's output on this process (tokens, latches or chains),
            #: when ``record_ticks`` was set on the class at construction: the
            #: check that a slice's followers hold the leader's tokens.
            self.tick_log: Optional[list] = [] if ServingEngine.record_ticks else None
        except BaseException:
            if self._channel is not None:
                try:
                    self._channel.handshake(failed=True)
                except Exception:
                    pass
            raise
        if self._channel is not None:
            self._channel.handshake(failed=False)
        if autostart:
            self.start()

    @staticmethod
    def _resolve_serving_mesh(tp, mesh, devices, device, accelerator, model, module):
        """This engine's slice mesh, or None (one device; JAX ``:1049-1100``).

        ``mesh=`` is validated tp-only (and checked against ``tp=``);
        ``tp=`` carves one slice of that width from ``devices`` (default
        every visible card, or ``device`` repeated when it is the CPU).
        Otherwise a mesh of the accelerator (or of the prepared model's
        layout) routes automatically when it is a tp-only mesh above one
        process; when it is not tp-only and the model's parameters are split
        over it, that raises, since serving them whole would need every
        process's chunks; a mesh over unsplit parameters keeps one
        device."""
        if mesh is not None:
            validate_serving_mesh(mesh)
            if tp is not None and int(mesh.shape["tp"]) != int(tp):
                raise ValueError(f"mesh= has tp={mesh.shape['tp']} but tp={tp} was also "
                                 "passed; drop one or make them agree")
            if isinstance(mesh, SliceMesh):
                return mesh
            tp = int(mesh.shape["tp"])
        if tp is not None:
            if devices is None and device is not None and torch.device(device).type == "cpu":
                devices = [torch.device("cpu")] * int(tp)
            return SlicePlan.plan(int(tp), num_slices=1, devices=devices).build_mesh(0)
        if devices is not None:
            raise ValueError("devices= only makes sense together with tp=")
        layout = getattr(model, "layout", None) or getattr(module, "_sharded_layout", None)
        resolved = getattr(accelerator, "mesh", None)
        if resolved is None and layout is not None:
            resolved = layout.mesh
        if resolved is None or resolved.size_total <= 1:
            return None
        tp_size = int(resolved.shape.get("tp", 1))
        if math.prod(s for ax, s in resolved.shape.items() if ax != "tp") == 1 and tp_size > 1:
            # A tp-only training mesh: serve sliced.
            cpu = device is not None and torch.device(device).type == "cpu"
            return SlicePlan.plan(tp_size, num_slices=1,
                                  devices=[torch.device("cpu")] * tp_size if cpu
                                  else None).build_mesh(0)
        spanned = layout is not None and any(
            ax != "tp" and resolved.shape.get(ax, 1) > 1
            for split in layout.splits.values() for ax in split)
        if spanned:
            raise ValueError(
                f"params are sharded across {resolved.size_total} processes on a "
                f"non-tensor-parallel mesh ({dict(resolved.shape)}); the serving engine only "
                "runs tp-only slices. Re-prepare the model under MeshConfig(dp=1, tp=N), pass "
                "tp=/mesh= explicitly, or gather params to host before serving.")
        return None

    # ------------------------------------------------------------------
    # device state and the steps
    # ------------------------------------------------------------------
    def _build_state(self, cfg, max_pages):
        """Allocate the decode state, the steps' static inputs and outputs
        and the host staging buffers."""
        dev, S = self.device, self.max_slots
        C, K = self._chunk or 0, self._spec_k or 0
        L = cfg.num_hidden_layers
        long = dict(dtype=torch.int64, device=dev)
        if self._paged:
            P = self._page
            # The view holds max_len + K positions: a verify near the end of
            # a stream writes up to pos + K.
            self._pages_per_slot = -(-(self.max_len + K) // P)
            usable = (int(max_pages) if max_pages is not None
                      else self.max_slots * -(-self.max_len // P))
            if usable < 1:
                raise ValueError(f"max_pages must be >= 1 (got {max_pages})")
            self._pool = PagePool(usable)
            self._table = np.zeros((S, self._pages_per_slot), np.int64)
            # +1: page 0 is the scratch page inactive writes route to.
            self._kv, self._pscale, self._page_bytes = self._pool_state(
                cfg, usable + 1, self._kv_heads, self._kv_hd)
            Np = self._pages_per_slot
        else:
            self._pool = None
            self._table = None
            self._pages_per_slot = Np = 0
            shape = (S, self._kv_heads, self.max_len, self._kv_hd)
            self._kv = [{"k": torch.zeros(shape, dtype=self._dtype, device=dev),
                         "v": torch.zeros(shape, dtype=self._dtype, device=dev)}
                        for _ in range(L)]
            self._pscale = None
            self._page_bytes = 0
        if self._spec_mode == "draft":
            # Draft pages: the same pool's ids through their own table, at
            # the draft's widths.
            self._dkv, self._dpscale, self._draft_page_bytes = self._pool_state(
                self._draft.config, usable + 1)
            self._dtable = np.zeros((S, Np), np.int64)
        else:
            self._dkv = self._dpscale = self._dtable = None
            self._draft_page_bytes = 0
        self._pos = torch.zeros(S, **long)
        self._tok = torch.zeros(S, **long)
        self._done = torch.zeros(S, dtype=torch.bool, device=dev)
        self._seed = torch.zeros(S, **long)
        self._adapter_idx = torch.zeros(S, **long) if self._adapters is not None else None
        # The token at position pos - 1 (draft engines): the draft scan
        # starts from it, so every committed token's draft K/V is written.
        self._prev = torch.zeros(S, **long) if self._spec_mode == "draft" else None
        self._zero = torch.zeros(1, **long)
        itemsize = torch.finfo(self._dtype).bits // 8
        # A prefix block is whole on every process of a slice (head-major).
        self._block_shape = (L, 2, cfg.num_key_value_heads, C, cfg.head_dim)
        self._block_bytes = L * 2 * C * cfg.num_key_value_heads * cfg.head_dim * itemsize

        # Static inputs (one int64 tensor a step, so one copy a call) and
        # outputs. Layouts: tick [active S | table S*Np], and on a
        # speculative engine then [dtable S*Np (draft) | remaining S |
        # proposals S*K (lookup)]; chunk [ids C | slot | offset | true_len |
        # seed | row Np | adapter row (bank) | draft row Np (draft)];
        # draft chunk [ids C | offset | draft row Np]; restore [slot |
        # offset | true_len] (dense) or [slot | true_len | pages C/P]
        # (paged); a monolithic prefill of width W [ids W | slot | true_len
        # | seed | adapter row (bank)]. The tick's output is [K+2, S]:
        # tokens and EOS latches, or the verify's emitted chains and counts.
        bank = 1 if self._adapters is not None else 0
        tick_width = S + S * Np
        if self._spec_k is not None:
            tick_width += S + (S * Np if self._spec_mode == "draft" else S * K)
        self._restore_width = 3 if not self._paged else 2 + C // self._page
        self._decode_in = torch.zeros(tick_width, **long)
        self._decode_out = torch.zeros(K + 2, S, **long)
        self._chunk_in = torch.zeros(C + 4 + Np + bank + (Np if self._dkv is not None else 0),
                                     **long)
        self._chunk_out = torch.zeros(1, **long)
        self._restore_in = torch.zeros(self._restore_width, **long)
        self._dchunk_in = torch.zeros(C + 1 + Np, **long) if self._dkv is not None else None
        self._prefill_in: dict = {}     # monolithic width -> static input
        self._prefill_stage: dict = {}
        if self._copy_restore:
            self._block_out = torch.zeros(self._block_shape, dtype=self._dtype, device=dev)
            self._block_in = torch.zeros(self._block_shape, dtype=self._dtype, device=dev)
        else:
            self._block_out = self._block_in = None
        # A follower's buffers for what the leader's channel sends besides a
        # step's input: a restore's block, a bank row.
        follower = self._channel is not None and not self.leader
        self._block_host = (torch.zeros(self._block_shape, dtype=self._dtype)
                            if follower and self._copy_restore else None)
        self._bank_host = (torch.zeros(self._adapters.row_size, dtype=torch.float32)
                           if follower and self._adapters is not None else None)

        # The tick's staging and outputs are double-buffered (see the
        # module docstring); chunk and restore calls wait on their event
        # before their one buffer is written again.
        self._decode_stage = [self._host(self._decode_in.numel()) for _ in range(2)]
        self._decode_host_out = [self._host(self._decode_out.numel()) for _ in range(2)]
        self._chunk_stage = self._host(self._chunk_in.numel())
        self._chunk_host_out = self._host(1)
        self._restore_stage = self._host(self._restore_width)
        self._dchunk_stage = (self._host(self._dchunk_in.numel())
                              if self._dchunk_in is not None else None)
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
        self._window_frees = 0  # page references dropped behind a sliding window

    def _host(self, n: int) -> torch.Tensor:
        """A host int64 staging buffer (pinned on the card)."""
        return torch.zeros(n, dtype=torch.int64, pin_memory=self._on_card)

    def _pool_state(self, cfg, pages: int, n_kv: Optional[int] = None, hd: Optional[int] = None):
        """Head-major K/V pages ``[pages, n_kv, P, hd]`` per layer of a model
        with ``cfg`` (int8 under ``kv_dtype="int8"``, with one f32 scale a
        page and leaf: rows ``[2 * layers, pages]``, layer ``i``'s K at row
        ``2i`` and V at ``2i + 1``, initialised to ones), and the bytes of
        one page over every layer, scales included. ``n_kv``/``hd``: this
        process's widths on a slice (default the config's)."""
        n_kv = cfg.num_key_value_heads if n_kv is None else n_kv
        hd = cfg.head_dim if hd is None else hd
        L, P = cfg.num_hidden_layers, self._page
        quant = self._kv_dtype is not None
        dtype = torch.int8 if quant else self._dtype
        shape = (pages, n_kv, P, hd)
        kv = [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
               "v": torch.zeros(shape, dtype=dtype, device=self.device)} for _ in range(L)]
        scales = (torch.ones((2 * L, pages), dtype=torch.float32, device=self.device)
                  if quant else None)
        elem = 1 if quant else torch.finfo(self._dtype).bits // 8
        return kv, scales, L * 2 * (P * n_kv * hd * elem + (4 if quant else 0))

    def _layer_caches(self, kv, rows=None, table=None, write=None):
        """Per-layer cache dicts over ``kv`` for one step's forward (the
        layouts of ``models.llama._update_slots_and_attend``)."""
        if self._paged:
            return [{"k": c["k"], "v": c["v"], "table": table, "write": write} for c in kv]
        return [{"k": c["k"], "v": c["v"], "rows": rows} for c in kv]

    def _views(self, kv, scales, table):
        """Dequantized views of the rows of ``table`` [B, Np] over int8
        pages ``kv`` (JAX ``_gather_view`` ``:1327``): per layer ``{"k",
        "v"}`` [B, n_kv, Np * P, hd] in the cache dtype, slot-row caches that
        the forward writes its K/V into and attends at full precision
        before :meth:`_requant` puts the written pages back."""
        B, Np = table.shape
        flat = table.reshape(-1)
        views = []
        for i, c in enumerate(kv):
            G, P, hd = c["k"].shape[1:]
            blocks = (table[:, None, :] * G
                      + torch.arange(G, device=table.device)[None, :, None]).reshape(-1)
            layer = {}
            for j, name in enumerate(("k", "v")):
                q = c[name].view(-1, P, hd).index_select(0, blocks).view(B, G, Np, P, hd)
                s = scales[2 * i + j].index_select(0, flat).view(B, 1, Np, 1, 1)
                # q * s in f32, rounded once to the cache dtype as it is stored.
                view = torch.empty((B, G, Np, P, hd), dtype=self._dtype, device=q.device)
                layer[name] = torch.mul(q, s, out=view).view(B, G, Np * P, hd)
            views.append(layer)
        return views

    def _requant(self, kv, scales, views, table, pos, last_off: int, steps: int, active=None):
        """Requantize whole, from ``views``, the pages each row of ``table``
        wrote (positions ``pos .. pos + last_off``) into the pool and their
        scales (JAX ``_scatter_page`` ``:1352``, ``_scatter_slot_pages``
        ``:1555``): ``steps`` pages a row, those past its writes and every
        page of a row outside ``active`` going to the scratch page."""
        B, Np = table.shape
        P = self._page
        tp = (pos // P)[:, None] + torch.arange(steps, device=table.device)   # [B, steps]
        touched = (tp * P <= (pos + last_off)[:, None]) & (tp >= 0) & (tp < Np)
        if active is not None:
            touched = touched & active[:, None]
        tpc = tp.clamp(0, Np - 1)
        tgt = torch.where(touched, table.gather(1, tpc), torch.zeros_like(tpc)).reshape(-1)
        rows = torch.arange(B, device=table.device)[:, None]
        group = self._scale_group(kv)
        for i, (c, view) in enumerate(zip(kv, views)):
            for j, name in enumerate(("k", "v")):
                G, _, hd = c[name].shape[1:]
                blocks = view[name].view(B, G, Np, P, hd)[rows, :, tpc]  # [B, steps, G, P, hd]
                q, s = _quant_page(blocks.reshape(B * steps, G, P, hd).float(), group)
                c[name].index_copy_(0, tgt, q)
                scales[2 * i + j].index_copy_(0, tgt, s)

    def _scale_group(self, kv):
        """The slice's tp group for the target's pages (their page scales
        are the slice's MAX), None for the draft's (whole on every
        process)."""
        return self._slice_group if kv is self._kv else None

    def _whole(self, part):
        """A ``[n_kv, C, hd]`` K or V slice of a block, whole: this
        process's share gathered over the slice."""
        if self._slice_group is None:
            return part
        return self._slice_group.all_gather(part.contiguous(), 0 if self._kv_axis == 2 else 2)

    def _local_block(self, blk):
        """This process's share of a whole block ``[layers, 2, n_kv, C,
        hd]`` (contiguous)."""
        if self._slice_group is None:
            return blk
        dim = 2 if self._kv_axis == 2 else 4
        k = blk.shape[dim] // self.tp
        return blk.narrow(dim, self._exec.index * k, k).contiguous()

    def _lora(self, rows):
        """The ``lora=`` argument of a forward whose rows decode under bank
        rows ``rows`` [B]; None without a bank."""
        return None if self._adapters is None else self._adapters.gather(rows)

    def _target_cache(self, table, write=None, rows=None):
        """The target model's caches for one step: dequantized views of the
        rows of ``table`` over int8 pages, else the pool or slot rows."""
        if self._pscale is not None:
            return self._views(self._kv, self._pscale, table)
        return self._layer_caches(self._kv, rows=rows, table=table, write=write)

    def _decode_step(self):
        """One tick over every slot (JAX ``_decode_fn`` / ``_paged_decode_fn``):
        one batched forward at per-slot positions, the KV commit
        unconditional (paged: slots outside the mask write to scratch), then
        ``pos``/``tok``/``done`` advance where the mask is set."""
        S, Np = self.max_slots, self._pages_per_slot
        active = self._decode_in[:S].bool()
        table = self._decode_in[S:].view(S, Np) if self._paged else None
        pos = self._pos
        cache = self._target_cache(table, write=active)
        logits, _ = self.module(self._tok[:, None], cache=cache, cache_pos=pos,
                                lora=self._lora(self._adapter_idx))
        if self._pscale is not None:
            self._requant(self._kv, self._pscale, cache, table, pos, 0, 1, active)
        keys = torch.stack([self._seed, pos + 1], dim=1)  # the drawn token's position
        nxt, done = _next_token(logits[:, -1], keys, None, self._done, self._select,
                                self.eos_token_id, torch.int64)
        self._pos.copy_(torch.where(active, pos + 1, pos))
        self._tok.copy_(torch.where(active, nxt, self._tok))
        self._done.copy_(torch.where(active, done, self._done))
        self._decode_out[0].copy_(nxt)
        self._decode_out[1].copy_(done)

    def _spec_step(self):
        """One speculative tick over every slot (JAX ``_spec_lookup_fn``
        ``:1769`` and ``_spec_fn`` ``:1685``): the draft model's K steps
        through each slot's draft pages, or the host's lookup proposals,
        then ONE ``[max_slots, K+1]`` verify of ``[carry, drafts]`` at each
        slot's position, accepted by :func:`generation.speculative_emit_keyed`.
        A slot advances by ``n = min(accepted + 1, remaining)``. The K/V the
        verify (and the draft scan) wrote at rejected positions is garbage,
        but the next verify rewrites target positions ``pos + n .. pos + n
        + K`` (and the next scan draft positions ``pos + n .. pos + n + K -
        1``) before any query attends them (JAX ``:1698-1702``)."""
        S, Np, K = self.max_slots, self._pages_per_slot, self._spec_k
        buf = self._decode_in
        active = buf[:S].bool()
        at = S + S * Np
        table = buf[S:at].view(S, Np)
        if self._spec_mode == "draft":
            dtable = buf[at:at + S * Np].view(S, Np)
            at += S * Np
        remaining = buf[at:at + S]
        pos, tok = self._pos, self._tok
        if self._spec_mode == "draft":
            drafts = self._draft_scan(dtable, active)
        else:
            drafts = buf[at + S:].view(S, K)
        cache = self._target_cache(table, write=active)
        logits, _ = self.module(torch.cat([tok[:, None], drafts], dim=1), cache=cache,
                                cache_pos=pos, lora=self._lora(self._adapter_idx))
        if self._pscale is not None:
            self._requant(self._kv, self._pscale, cache, table, pos, K, K // self._page + 2,
                          active)
        m, emit = speculative_emit_keyed(logits, drafts, self._seed, pos, self._warp,
                                         self.eos_token_id, torch.int64, self._done)
        n = torch.minimum(m + 1, remaining)
        new_tok = emit.gather(1, (n - 1).clamp(0, K)[:, None])[:, 0]
        new_done = new_tok == self.eos_token_id if self.eos_token_id is not None else self._done
        if self._prev is not None:
            # The token before the new carry: emit[n - 2], or the old carry.
            before = emit.gather(1, (n - 2).clamp(0, K)[:, None])[:, 0]
            self._prev.copy_(torch.where(active, torch.where(n >= 2, before, tok), self._prev))
        self._pos.copy_(torch.where(active, pos + n, pos))
        self._tok.copy_(torch.where(active, new_tok, tok))
        self._done.copy_(torch.where(active, new_done, self._done))
        self._decode_out[:K + 1].copy_(emit.T)
        self._decode_out[K + 1].copy_(n)

    def _draft_scan(self, dtable, active):
        """K draft steps from each slot's carry token through its draft
        pages (JAX ``_spec_fn``'s scan): each draft is the argmax of the
        warped draft logits, a delta proposal. Returns [S, K].

        The first step feeds ``[prev, carry]`` at ``pos - 1``: after a tick
        that accepted all K drafts, the last of them sits at ``pos - 1``
        and no step has written its draft K/V yet (the JAX scan leaves that
        position stale, ROADMAP.md C); rewriting it otherwise recomputes
        the same token's K/V. So a model drafting for itself accepts every
        draft."""
        K, pos = self._spec_k, self._pos
        quant = self._dpscale is not None
        cache = (self._views(self._dkv, self._dpscale, dtable) if quant
                 else self._layer_caches(self._dkv, table=dtable, write=active))
        cur, drafts = self._tok, []
        for k in range(K):
            if k == 0:
                logits, _ = self._draft(torch.stack([self._prev, cur], dim=1), cache=cache,
                                        cache_pos=pos - 1)
            else:
                logits, _ = self._draft(cur[:, None], cache=cache, cache_pos=pos + k)
            row = logits[:, -1]
            if self._warp is not None:
                row = self._warp(row)
            cur = row.argmax(dim=-1)
            drafts.append(cur)
        if quant:
            self._requant(self._dkv, self._dpscale, cache, dtable, pos - 1, K,
                          K // self._page + 2, active)
        return torch.stack(drafts, dim=1)

    def _chunk_step(self):
        """One ``[1, C]`` prompt chunk at a tensor offset (JAX
        ``_prefill_chunk_fn`` / ``_paged_prefill_chunk_fn``): writes the
        chunk's KV into the slot (its rows, or its pages), selects the
        candidate first token, pins ``pos[slot] = true_len`` and writes the
        slot's ``tok``/``done``/``seed`` (and adapter row); where restores
        copy, also the chunk's KV block; a draft engine also runs the draft
        model over the chunk into the slot's draft pages."""
        C, Np = self._chunk, self._pages_per_slot
        buf = self._chunk_in
        ids = buf[:C].view(1, C)
        slot, offset, true_len, seed = buf[C:C + 1], buf[C + 1:C + 2], buf[C + 2:C + 3], buf[C + 3:C + 4]
        at = C + 4 + Np
        row = buf[C + 4:at].view(1, Np) if self._paged else None
        aidx = None
        if self._adapters is not None:
            aidx = buf[at:at + 1]
            at += 1
        cache = self._target_cache(row, rows=slot)
        logits, _ = self.module(ids, cache=cache, cache_pos=offset,
                                lora=None if aidx is None else self._lora(aidx))
        if self._pscale is not None:
            self._requant(self._kv, self._pscale, cache, row, offset, C - 1, C // self._page + 1)
        keys = torch.stack([seed, true_len], dim=1)  # token #1 sits at position true_len
        tok, done = _chunk_prefill_token(logits, keys, self._select, self.eos_token_id,
                                         torch.int64, true_len, offset)
        self._pos.index_copy_(0, slot, true_len)
        self._tok.index_copy_(0, slot, tok)
        self._done.index_copy_(0, slot, done)
        self._seed.index_copy_(0, slot, seed)
        if aidx is not None:
            self._adapter_idx.index_copy_(0, slot, aidx)
        if self._prev is not None:  # the last prompt token (real in the final chunk)
            last = (true_len - 1 - offset).clamp(0, C - 1)
            self._prev.index_copy_(0, slot, ids[0].index_select(0, last))
        self._chunk_out.copy_(tok)
        if self._block_out is not None:
            at_c = offset + torch.arange(C, device=buf.device)
            if self._pscale is not None:
                # The block of the full-precision view, as JAX slices it.
                for i, v in enumerate(cache):
                    self._block_out[i, 0].copy_(self._whole(v["k"][0][:, at_c]))
                    self._block_out[i, 1].copy_(self._whole(v["v"][0][:, at_c]))
            else:
                if self._paged:
                    index = (row[0, at_c // self._page], slice(None), at_c % self._page)
                else:
                    index = (slot.expand(C), slice(None), at_c)
                for i, c in enumerate(self._kv):  # [C, n_kv, hd] -> [n_kv, C, hd]
                    self._block_out[i, 0].copy_(self._whole(c["k"][index].transpose(0, 1)))
                    self._block_out[i, 1].copy_(self._whole(c["v"][index].transpose(0, 1)))
        if self._dkv is not None:
            self._draft_prefill(ids, offset, buf[at:at + Np].view(1, Np))

    def _draft_prefill(self, ids, offset, drow):
        """The draft model over one prompt chunk into the draft pages of
        ``drow`` [1, Np] (the draft half of JAX ``_paged_prefill_chunk_fn``,
        and ``_draft_chunk_fn`` ``:1469``); the draft stays base-weight."""
        C = ids.shape[1]
        quant = self._dpscale is not None
        cache = (self._views(self._dkv, self._dpscale, drow) if quant
                 else self._layer_caches(self._dkv, table=drow))
        self._draft(ids, cache=cache, cache_pos=offset, return_hidden=True)
        if quant:
            self._requant(self._dkv, self._dpscale, cache, drow, offset, C - 1,
                          C // self._page + 1)

    def _draft_chunk_step(self):
        """Rebuild a prefix-restored chunk's draft K/V (restored pages hold
        the target's K/V only)."""
        C, Np = self._chunk, self._pages_per_slot
        buf = self._dchunk_in
        self._draft_prefill(buf[:C].view(1, C), buf[C:C + 1], buf[C + 1:].view(1, Np))

    def _restore_step(self):
        """Copy one cached chunk block into a slot (JAX ``_restore_prefix_fn``
        / ``_paged_restore_prefix_fn``), quantizing its pages on an int8
        pool, and pin ``pos[slot] = true_len``."""
        C, buf, blk = self._chunk, self._restore_in, self._local_block(self._block_in)
        slot, G, hd = buf[0:1], blk.shape[2], blk.shape[4]
        if self._paged:
            true_len, pages = buf[1:2], buf[2:]
            shape = (G, C // self._page, self._page, hd)
            for i, c in enumerate(self._kv):  # [n_kv, C, hd] -> [C/P, n_kv, P, hd]
                for j, name in enumerate(("k", "v")):
                    pages_blk = blk[i, j].view(shape).transpose(0, 1)
                    if self._pscale is None:
                        c[name].index_copy_(0, pages, pages_blk)
                        continue
                    q, s = _quant_page(pages_blk.float(), self._slice_group)
                    c[name].index_copy_(0, pages, q)
                    self._pscale[2 * i + j].index_copy_(0, pages, s)
        else:
            offset, true_len = buf[1:2], buf[2:3]
            at = offset + torch.arange(C, device=buf.device)
            index = (slot.view(1, 1), torch.arange(G, device=buf.device).view(G, 1),
                     at.view(1, C))
            for i, c in enumerate(self._kv):
                c["k"].index_put_(index, blk[i, 0])
                c["v"].index_put_(index, blk[i, 1])
        self._pos.index_copy_(0, slot, true_len)

    def _prefill_step(self, width: int):
        """Monolithic prefill of one edge-padded prompt of ``width`` tokens
        (a 128-bucket) into a slot's rows from position 0 (JAX
        ``_prefill_fn`` ``:1154``): the first token as the chunk step
        selects it, and the slot's state."""
        buf = self._prefill_in[width]
        ids = buf[:width].view(1, width)
        slot, true_len, seed = (buf[width + i:width + i + 1] for i in range(3))
        aidx = buf[width + 3:width + 4] if self._adapters is not None else None
        logits, _ = self.module(ids, cache=self._layer_caches(self._kv, rows=slot),
                                cache_pos=self._zero,
                                lora=None if aidx is None else self._lora(aidx))
        keys = torch.stack([seed, true_len], dim=1)
        tok, done = _chunk_prefill_token(logits, keys, self._select, self.eos_token_id,
                                         torch.int64, true_len, 0)
        self._pos.index_copy_(0, slot, true_len)
        self._tok.index_copy_(0, slot, tok)
        self._done.index_copy_(0, slot, done)
        self._seed.index_copy_(0, slot, seed)
        if aidx is not None:
            self._adapter_idx.index_copy_(0, slot, aidx)
        self._chunk_out.copy_(tok)

    def _launch(self, name: str, step, device_in, stage, parts, block=None):
        """Copy ``parts`` ((name, values) pairs, laid end to end) through the
        host buffer ``stage`` into the step's static input ``device_in``
        (and a restore's ``block`` into the block input), then run the step.
        The parts' names and shapes are its signature. On a slice the
        channel first hands the followers the step, its input and the
        block."""
        view = stage.numpy()
        at = 0
        for _, values in parts:
            flat = np.asarray(values).reshape(-1)
            view[at:at + flat.size] = flat
            at += flat.size
        if at != view.size:
            raise ValueError(f"step {name!r} takes {view.size} input values, got {at}")
        if self._channel is not None:
            self._channel.send(STEP, _STEP_NAMES.index(name), stage,
                               None if block is None else block.to("cpu"))
        if block is not None:
            self._block_in.copy_(block, non_blocking=True)
        device_in.copy_(stage, non_blocking=True)
        signature = (name,) + tuple((k, np.shape(v)) for k, v in parts)
        self._graphs.run(name, step, signature)

    def _host_block(self) -> torch.Tensor:
        """The chunk step's block, whole, copied to the host (into pinned
        memory on the card: a pageable copy runs at a tenth of the rate)."""
        block = torch.empty(self._block_shape, dtype=self._dtype, pin_memory=self._on_card)
        return block.copy_(self._block_out)

    def _send_bank_row(self, row: int, host: dict):
        """The bank's row listener on a slice's leader: a loaded row goes to
        the followers whole."""
        self._channel.send(BANK_ROW, row, self._adapters.row_vector(host))

    # ------------------------------------------------------------------
    # a follower of a slice
    # ------------------------------------------------------------------
    def _follower_steps(self) -> dict:
        """Step name -> (step, static input, staging buffer)."""
        return {"decode": (self._decode_step, self._decode_in, self._decode_stage[0]),
                "spec": (self._spec_step, self._decode_in, self._decode_stage[0]),
                "chunk": (self._chunk_step, self._chunk_in, self._chunk_stage),
                "restore": (self._restore_step, self._restore_in, self._restore_stage),
                "draft_chunk": (self._draft_chunk_step, self._dchunk_in, self._dchunk_stage)}

    def _follow(self):
        """A follower's thread: take each message of the slice's channel and
        run it (a step on this process's shard, a bank row) until the
        leader's engine stops. A failure is reported to the leader at the
        next message, whose engine then dies of it; this thread ends."""
        stream = torch.cuda.stream(self._stream) if self._on_card else contextlib.nullcontext()
        steps = self._follower_steps()
        status = 0
        with torch.inference_mode(), stream, self.mesh:
            while True:
                self._loop_iters += 1
                if self._chaos is not None:
                    self._chaos.apply(self)
                if self._fail_injection is not None and not status:
                    self._error = self._fail_injection
                    status = 1
                kind, code, n, has_block = self._channel.receive(status)
                if status or kind == STOP:
                    break
                try:
                    if kind == STEP:
                        name = _STEP_NAMES[code]
                        step, device_in, stage = steps[name]
                        self._channel.receive_into(stage)
                        if has_block:
                            self._block_in.copy_(self._channel.receive_into(self._block_host))
                        device_in.copy_(stage)  # before the next message reuses stage
                        self._graphs.run(name, step, (name, n))
                        if name in ("decode", "spec"):
                            self._decode_ticks += 1
                            if self.tick_log is not None:
                                self.tick_log.append(
                                    self._decode_out.cpu().numpy().reshape(
                                        -1, self.max_slots).copy())
                    elif kind == BANK_ROW:
                        flat = self._channel.receive_into(self._bank_host)
                        self._adapters.write_row(code, self._adapters.row_from_vector(flat))
                    else:
                        raise RuntimeError(f"unexpected message kind {kind} on slice "
                                           f"{self.mesh.index}'s channel")
                except BaseException as e:
                    self._error = e
                    self._flight.record("fatal", error=repr(e))
                    status = 1
                    if kind == STEP:  # the leader is inside this step's collectives
                        self._exec.mesh.fence()
        if self._on_card:
            self._stream.synchronize()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        """Spawn the engine thread (idempotent) and run warmup traffic. A
        follower's thread follows its leader's steps instead."""
        if self._thread is not None:
            return
        if not self.leader:
            self._thread = threading.Thread(target=self._follow, name="serving-follower",
                                            daemon=True)
            self._thread.start()
            return
        self._accepting = True
        self._heartbeat = (self._loop_iters, time.monotonic())
        self._heartbeat_frozen = False
        if self._async and (self._emitter is None or not self._emitter.alive):
            self._emitter = _TokenEmitter(self._emission_queue)
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()
        if self._warmup_on_start:
            self.warmup()

    def warmup(self, timeout: float = 300.0):
        """Run every step once through the normal path, capturing its graph
        on the card: one chunk call (a monolithic engine: the prefill of the
        smallest bucket) and ticks (decode, or the speculative verify), and,
        when the engine has a prefix cache and a two-chunk prompt fits, two
        identical two-chunk prompts (the second restores: by copy, or by
        aliasing and, on a draft engine, the draft chunk). The requests run
        on the base model, bank row 0 on an adapter engine. ``ignore_eos`` keeps the
        dummies decoding. Stats, the prefix cache, spans, flight events and
        the capture events are cleared afterwards. A follower follows its
        leader's warmup."""
        if not self.leader:
            return
        req = self.submit(np.zeros((1, 1), np.int32), max_new_tokens=2, seed=0,
                          ignore_eos=True, block=True)
        if not req.wait(timeout):
            raise TimeoutError(f"engine warmup did not finish within {timeout}s")
        self._raise_if_failed(req)
        if (self._chunk is not None and self._prefix_cache is not None
                and self._chunk + 2 <= self._chunk_limit):
            ids = np.zeros((1, self._chunk + 1), np.int32)
            for _ in range(2):
                r = self.submit(ids, max_new_tokens=1, seed=0, ignore_eos=True, block=True)
                if not r.wait(timeout):
                    raise TimeoutError(f"engine warmup did not finish within {timeout}s")
                self._raise_if_failed(r)
        self._stats.reset()
        if self._prefix_cache is not None and self._external_cache:
            # A cache other engines share keeps their entries (a slice
            # rebuilt into a fleet finds its predecessor's prefixes warm):
            # only the warmup prompt's go.
            self._prefix_cache.discard(
                self._prefix_keys(np.zeros((1, self._chunk + 1), np.int32), 1))
        elif self._prefix_cache is not None:
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
        for the engine thread (up to ``timeout``). A slice's follower waits
        for its leader to stop (following it to the end if its thread never
        started); a leader that never started tells its followers to stop."""
        self._accepting = False
        if not self.leader:
            if self._thread is None and not self._channel_closed:
                self._channel_closed = True
                self._follow()
            elif self._thread is not None:
                self._thread.join(timeout)
                if not self._thread.is_alive():
                    self._thread = None
            if self._error is not None:
                raise RuntimeError("serving engine died") from self._error
            return
        if drain:
            self._drain = True
        else:
            self._stop = True
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None
        else:
            self._close_channel()
        self._queue.close()
        if self._emitter is not None:
            self._emitter.close(timeout)
        if self._trace_dir is not None and self._error is None:
            self._dump_debug_files()
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
    def _spec_page_factor(self) -> int:
        """Pages a token costs at admission: 2 on a draft engine (a draft
        page beside every target page, from the same pool), else 1."""
        return 2 if self._spec_mode == "draft" else 1

    def page_deficit(self, total_tokens: int) -> int:
        """Pages this engine is short for a request of ``total_tokens``
        (prompt + max_new) now: 0 when the pool holds it (and always on a
        dense engine), a draft engine counting its draft pages."""
        if not self._paged or total_tokens <= 0:
            return 0
        needed = -(-int(total_tokens) // self._page) * self._spec_page_factor
        return max(0, needed - self._pool.free_pages)

    @property
    def heartbeat(self) -> tuple:
        """``(loop_iterations, wall_time)`` published at the top of every
        loop iteration and at every reconcile."""
        return self._heartbeat

    @property
    def decode_ticks(self) -> int:
        return self._decode_ticks

    def page_drain_rate(self, window_s: float = 15.0) -> float:
        """Pages freed per second over the last ``window_s`` of decode
        ticks (0.0 when dense or not yet observed): the denominator of the
        gateway's pressure-shed Retry-After."""
        if not self._paged:
            return 0.0
        samples = list(self._drain_samples)
        if len(samples) < 2:
            return 0.0
        now = time.monotonic()
        recent = [s for s in samples if now - s[0] <= window_s]
        if len(recent) < 2:
            recent = samples[-2:]
        (t0, f0), (t1, f1) = recent[0], recent[-1]
        if t1 <= t0 or f1 <= f0:
            return 0.0
        return (f1 - f0) / (t1 - t0)

    def projected_page_deficit(self, total_tokens: int) -> int:
        """Pages the pool is short if a ``total_tokens`` request is admitted
        behind the queued work: its pages plus the queue's, less the free
        pages, floored at 0 (a dense engine is never short)."""
        if not self._paged or total_tokens <= 0:
            return 0
        factor = self._spec_page_factor
        needed = -(-int(total_tokens) // self._page) * factor
        queued = -(-int(self._queue.pending_tokens) // self._page) * factor
        return max(0, needed + queued - self._pool.free_pages)

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
               adapter: Optional[str] = None, trace_id: Optional[str] = None,
               priority: Optional[str] = None, block: bool = False,
               block_timeout: Optional[float] = None) -> Request:
        """Enqueue one request; returns its :class:`Request` handle at once.
        Raises :class:`~.scheduler.QueueFull` under backpressure when
        ``block=False``; ``block=True`` waits for queue space (up to
        ``block_timeout``). ``seed`` (or ``rng`` as an int) keys a sampled
        request's draws. ``adapter`` names a registered LoRA adapter of the
        engine's bank (an unknown name raises
        :class:`~accelerate_tpu_torch.adapters.UnknownAdapterError` here). A
        ``request=`` handle must be fresh."""
        if not self.leader:
            raise RuntimeError(
                f"this process follows serving slice {self.mesh.index}; submit requests on "
                "its leader, process 0")
        if request is None:
            request = Request(prompt_ids, max_new_tokens=max_new_tokens, rng=rng, seed=seed,
                              timeout=timeout, on_token=on_token, ignore_eos=ignore_eos,
                              adapter=adapter, trace_id=trace_id, priority=priority)
        elif request.status is not RequestStatus.QUEUED or request.submitted_at is not None:
            raise ValueError(
                f"Request handle already used (status {request.status.value}); Request "
                "objects are single-use — build a fresh Request (or pass prompt_ids)")
        if request.adapter is not None:
            if self._adapters is None:
                raise ValueError(f"request names adapter {request.adapter!r} but this engine "
                                 "has no adapter bank (pass adapters=AdapterBank(...))")
            self._adapters.check_known(request.adapter)
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
            need = -(-(S + request.max_new_tokens) // self._page) * self._spec_page_factor
            if need > self._pool.num_pages:
                raise ValueError(
                    f"request needs up to {need} KV pages (prompt {S} + max_new_tokens "
                    f"{request.max_new_tokens} at page_size {self._page}"
                    + (", doubled for draft KV pages" if self._spec_page_factor > 1 else "")
                    + f") but the pool only has {self._pool.num_pages}; raise max_pages or "
                    "shorten the request")
        if self._spec_k is not None:
            # A verify near the end of a stream writes up to position
            # (S + max_new - 1) + K; the draft scan stops one short.
            K = self._spec_k
            _check_position_bound(self.module, S + request.max_new_tokens + K)
            if self._draft is not None:
                _check_position_bound(self._draft, S + request.max_new_tokens + K - 1)
        else:
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

    def _dump_debug_files(self):
        """Best-effort trace and flight dump into ``trace_dir`` (a full disk
        must not mask a death or a shutdown)."""
        try:
            os.makedirs(self._trace_dir, exist_ok=True)
            base = os.path.join(self._trace_dir, self._tracer.name)
            self._tracer.dump(base + "-trace.json")
            self._flight.dump_json(base + "-flight.json")
        except OSError:
            pass

    @property
    def adapters(self) -> Optional[AdapterBank]:
        return self._adapters

    def register_adapter(self, name: str, adapter, **kwargs) -> None:
        """Register a named LoRA adapter with this engine's bank (host side;
        its row loads at its first request)."""
        if self._adapters is None:
            raise RuntimeError("engine has no adapter bank; construct it with "
                               "adapters=AdapterBank(model, ...)")
        self._adapters.register(name, adapter, **kwargs)

    def adapter_resident(self, name: str) -> bool:
        """Whether ``name`` holds a bank row now."""
        return self._adapters is not None and self._adapters.resident(name)

    @property
    def kv_dtype(self) -> Optional[str]:
        """``"int8"`` when KV pages are stored quantized; None = the cache
        dtype, exact."""
        return self._kv_dtype

    @property
    def weights_dtype(self) -> Optional[str]:
        """``"int8"`` when the base projections are stored quantized (the
        LoRA path full precision); None = the model's weights as given."""
        return self._weights_dtype

    def kv_cache_per_chip_bytes(self) -> int:
        """Bytes of the decode K/V state on one device: the page pool (the
        draft's too) with its scales, or the dense slot rows. On a slice,
        this process's share (JAX ``:2279-2293``, through
        ``SliceExec.per_chip_bytes``): the K/V leaves split on their heads
        axis, the scales and the draft's pool whole."""
        tensors = [t for c in self._kv for t in c.values()]
        if self._dkv is not None:
            tensors += [t for c in self._dkv for t in c.values()]
        tensors += [t for t in (self._pscale, self._dpscale) if t is not None]
        if self._exec is not None:
            return self._exec.per_chip_bytes(tensors)
        return sum(t.numel() * t.element_size() for t in tensors)

    def page_pool_metrics(self) -> dict:
        """Host-side pool snapshot (empty for dense engines). On an int8
        engine ``page_bytes`` is the int8 figure (a byte an element and a
        4-byte scale a leaf)."""
        if not self._paged:
            return {}
        out = {
            "page_size": self._page,
            "kv_dtype": self._kv_dtype,
            "pages_per_slot": self._pages_per_slot,
            "page_bytes": self._page_bytes,
            "pages_total": self._pool.num_pages,
            "pages_free": self._pool.free_pages,
            "pages_used": self._pool.used_pages,
            "page_allocations": self._pool.allocations,
            "preemptions": self._pool.preemptions,
            "window_pages_freed": self._window_frees,
        }
        if self._spec_mode == "draft":
            out["draft_page_bytes"] = self._draft_page_bytes
        return out

    def cached_prefix_tokens(self, prompt_ids, adapter: Optional[str] = None) -> int:
        """Leading prompt tokens this engine could restore from its prefix
        cache now for a request under ``adapter`` (host work only; no LRU
        promotion)."""
        if self._prefix_cache is None or self._chunk is None:
            return 0
        ids = np.asarray(prompt_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        S, C = int(ids.shape[1]), self._chunk
        restorable = min(S // C, -(-S // C) - 1)
        if restorable < 1:
            return 0
        return self._prefix_cache.longest_prefix(
            self._prefix_keys(ids, restorable, adapter)) * C

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _run(self):
        stream = torch.cuda.stream(self._stream) if self._on_card else contextlib.nullcontext()
        mesh = self.mesh if self.mesh is not None else contextlib.nullcontext()
        with torch.inference_mode(), stream, mesh:
            self._run_loop()

    def _close_channel(self):
        """Tell a slice's followers that this engine stopped (once; not when
        a follower's failure already ended the conversation)."""
        if self._channel is None or self._channel_closed:
            return
        self._channel_closed = True
        if self._channel.alive:
            try:
                self._channel.send(STOP)
            except Exception as e:  # the engine is going either way
                self._flight.record("channel_stop_failed", error=repr(e))

    def _run_loop(self):
        # The one launched-but-unread tick (async mode). Loop shape per
        # iteration: sweeps -> admission -> LAUNCH tick N+1 -> RECONCILE
        # tick N, so host work between the two overlaps tick N+1.
        flight: Optional[_TickFlight] = None
        try:
            while not self._stop:
                # Chaos first (a scripted kill sets the injection checked
                # next), then the heartbeat, unless a chaos hang froze it.
                self._loop_iters += 1
                if self._chaos is not None:
                    self._chaos.apply(self)
                if not self._heartbeat_frozen:
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
                # (round-robin) with one new admission. A monolithic engine
                # prefills each admitted prompt whole, inline.
                budget = self._chunks_per_tick if self._chunk is not None else 0
                while self._chunk is None and self._slots.has_free():
                    req = self._queue.get_nowait()
                    if req is None:
                        break
                    if self._screen(req, now):
                        self._admit(req)
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
                        if self._spec_mode == "lookup" and flight is not None:
                            # Lookup proposals anchor on the newest committed
                            # token: a proposal drafted one variable-length
                            # tick behind verifies to nothing. So a lookup
                            # engine settles tick N before drafting N+1.
                            self._reconcile(flight)
                            flight = None
                            continue
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
                        if self._chunk is None:
                            self._admit(req)
                        else:
                            self._begin_prefill(req, self._chunks_per_tick)
        except BaseException as e:  # engine-fatal: fail everything loudly
            if (self._channel is not None and not isinstance(e, SliceFollowerError)
                    and self._exec.mesh.follower_failed()):
                # The collective failed because a follower fenced the slice.
                failed = SliceFollowerError(
                    f"a follower process of serving slice {self.mesh.index} failed inside a "
                    "step (its error is raised in that process)")
                failed.__cause__ = e
                e = failed
            self._error = e
            self._flight.record("fatal", error=repr(e))
            self._postmortem = self._flight.dump()
            if self._trace_dir is not None:
                self._dump_debug_files()
            if self._on_card:
                # A launched tick may still be replaying: let it finish
                # before the requests fail over and the engine is dropped.
                try:
                    self._stream.synchronize()
                except Exception:
                    pass
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
            self._close_channel()

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

    def _acquire_adapter(self, req: Request) -> bool:
        """Pin the request's adapter into a bank row before it takes a slot
        (base requests: row 0, the identity). An unknown name or a bank
        whose rows are all pinned fails THIS request with that error; the
        engine stays healthy. False when the request failed."""
        if self._adapters is None or req.adapter is None:
            req._adapter_row = 0
            return True
        try:
            row, hit, evicted = self._adapters.acquire(req.adapter)
        except Exception as e:
            self._finish_req(req, RequestStatus.FAILED, e)
            self._stats.record_finish(req.status)
            return False
        req._adapter_row = row
        req._adapter_pinned = True
        self._stats.record_adapter_admit(req.adapter, hit=hit, evicted=evicted)
        if not hit:
            self._flight.record("adapter_load", adapter=req.adapter, row=row, evicted=evicted,
                                trace_id=req.trace_id)
        return True

    def _adapter_part(self, req: Request) -> list:
        """The adapter-row part of a prefill step's input (bank engines)."""
        return [] if self._adapters is None else [("adapter", [req._adapter_row])]

    def _release_adapter(self, req: Request):
        if req._adapter_pinned:
            req._adapter_pinned = False
            self._adapters.release(req.adapter)

    # -- host-side page accounting (engine thread only) -----------------
    def _on_prefix_evict(self, key, value):
        """Alias-cache eviction hook: give back the page refs it held."""
        for pid in value:
            self._pool.decref(int(pid))

    def _release_slot_pages(self, slot: int):
        """Drop the slot's reference on every page of its table (and of its
        draft table) and clear the rows."""
        rows = [self._table[slot]]
        if self._dtable is not None:
            rows.append(self._dtable[slot])
        for row in rows:
            for idx in range(self._pages_per_slot):
                if row[idx]:
                    self._pool.decref(int(row[idx]))
            row[:] = 0

    def _alloc_page_into(self, req: Request, idx: int, table=None) -> bool:
        """Allocate one page into ``table[req.slot, idx]`` (the target
        table by default; the draft table shares the pool's id space); on
        exhaustion first reclaim alias-cache entries LRU-first, then
        preempt. False only when the requester is alone and the pool is
        still dry."""
        table = self._table if table is None else table
        while True:
            pid = self._pool.alloc()
            if pid is not None:
                table[req.slot, idx] = pid
                return True
            if self._alias_cache and self._prefix_cache.evict_lru():
                continue
            if not self._preempt_one(req):
                return False

    def _ensure_pages(self, req: Request, upto_pos: int) -> bool:
        """Cover position ``upto_pos`` in the slot's table. Entries below
        the request's window floor were freed on purpose (sliding-window
        page lifetime) and stay free."""
        row = self._table[req.slot]
        for idx in range(req._page_floor, upto_pos // self._page + 1):
            if not row[idx]:
                if not self._alloc_page_into(req, idx):
                    return False
        return True

    def _ensure_draft_pages(self, req: Request, upto_pos: int) -> bool:
        """Cover position ``upto_pos`` in the slot's draft table (the draft
        cache is linear: its pages live while the slot does)."""
        row = self._dtable[req.slot]
        for idx in range(upto_pos // self._page + 1):
            if not row[idx]:
                if not self._alloc_page_into(req, idx, table=self._dtable):
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
        self._release_adapter(victim)
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
        req._page_floor = 0  # every (re)admission prefills from page 0
        S = req._serve_ids.shape[1]
        C = self._chunk
        if self._paged:
            need = -(-S // self._page) * self._spec_page_factor
            if need > self._pool.free_pages + self._reclaimable_pages():
                self._flight.record("pool_exhausted", trace_id=req.trace_id,
                                    need_pages=need, free_pages=self._pool.free_pages)
                try:
                    self._queue.putleft(req)
                except QueueClosed:
                    req._finish(RequestStatus.CANCELLED)
                    self._stats.record_finish(req.status)
                return None
        if not self._acquire_adapter(req):
            return budget
        req.admitted_at = time.monotonic()
        slot = self._slots.assign(req)
        self._flight.record("admission", trace_id=req.trace_id, slot=slot, prompt_len=S,
                            adapter=req.adapter, resumed=bool(req.tokens))
        req.status = RequestStatus.PREFILLING
        seed = req.seed if req.seed is not None else (req.rng if req.rng is not None else 0)
        req._rng_key = int(seed) & _SEED_MASK
        req._chunks_total = -(-S // C)
        req._next_chunk = 0
        req._chunk_keys = None
        if self._prefix_cache is not None:
            n_full = S // C
            if n_full:
                req._chunk_keys = self._prefix_keys(req._serve_ids, n_full, req.adapter)
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
                    self._launch("restore", self._restore_step, self._restore_in,
                                 self._restore_stage, parts, block=blk)
                    self._restore_event.record(self._stream)
                    restored_bytes += self._block_bytes
                if blocks and self._dkv is not None:
                    # The cache holds the target's K/V only: rebuild the
                    # draft's for the restored span, chunk by chunk.
                    for i in range(len(blocks)):
                        if not self._ensure_draft_pages(req, (i + 1) * C - 1):
                            raise RuntimeError(
                                "page pool exhausted during the draft prefix rebuild; the "
                                "admission gate's draft factor should make this impossible")
                        parts = [("ids", req._serve_ids[0, i * C:(i + 1) * C]),
                                 ("offset", [i * C]), ("drow", self._dtable[slot])]
                        self._chunk_event.synchronize()  # its staging buffer is free again
                        self._launch("draft_chunk", self._draft_chunk_step, self._dchunk_in,
                                     self._dchunk_stage, parts)
                        self._chunk_event.record(self._stream)
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

    def _prefix_keys(self, prompt_ids, n_full: int, adapter: Optional[str] = None) -> list:
        """Hash-chain digests of the prompt's full chunks: chunk i's key
        covers tokens ``[0, (i+1)*C)`` (each digest folds in the previous).
        The chain is seeded with the KV dtype and the request's adapter: an
        adapter changes the K/V a prefix produces (two tenants never share
        blocks), and int8 pages carry their quantization and need their own
        pool's scales (an int8 and a full-precision engine sharing a cache
        never restore each other's blocks)."""
        flat = np.ascontiguousarray(prompt_ids[0], np.int32)
        C = self._chunk
        seed = b"chunk:%d" % C
        if self._kv_dtype is not None:
            seed += b"/kv:" + self._kv_dtype.encode("utf-8")
        if adapter is not None:
            seed += b"/adapter:" + adapter.encode("utf-8")
        keys, prev = [], seed
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
        parts += self._adapter_part(req)
        if self._dkv is not None:
            if not self._ensure_draft_pages(req, offset + C - 1):
                raise RuntimeError("page pool exhausted mid-prefill for draft KV; the admission "
                                   "gate's draft factor should make this impossible")
            parts.append(("drow", self._dtable[req.slot]))
        tok = self._prefill_call("chunk", self._chunk_step, self._chunk_in, self._chunk_stage,
                                 parts)
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
                # On a slice the block is kept on the host: it restores into
                # any slice (JAX ``:3010-3016``).
                block = self._block_out.clone() if self._exec is None else self._host_block()
                self._prefix_cache.put(req._chunk_keys[i], block, nbytes=self._block_bytes)
            self._stats.record_prefix_cache_size(self._prefix_cache.nbytes,
                                                 len(self._prefix_cache))
        req._next_chunk = i + 1
        if final:
            self._finish_prefill(req, tok)

    def _admit(self, req: Request):
        """Monolithic admission (``prefill_chunk=None``, JAX ``_admit``
        ``:2723``): edge-pad the prompt on the host to its 128-bucket, run
        it whole through that bucket's prefill step (a graph captured at
        the bucket's first use), and commit the first token."""
        if not self._acquire_adapter(req):
            return
        req.admitted_at = time.monotonic()
        slot = self._slots.assign(req)
        self._flight.record("admission", trace_id=req.trace_id, slot=slot,
                            prompt_len=req.prompt_ids.shape[1], adapter=req.adapter)
        req._serve_ids = req.prompt_ids
        S = req.prompt_ids.shape[1]
        W = self._bucket(S)
        ids = req.prompt_ids[0]
        if W > S:
            ids = np.pad(ids, (0, W - S), mode="edge")
        seed = req.seed if req.seed is not None else (req.rng if req.rng is not None else 0)
        req._rng_key = int(seed) & _SEED_MASK
        if W not in self._prefill_in:
            self._prefill_in[W] = torch.zeros(W + 3 + (self._adapters is not None),
                                              dtype=torch.int64, device=self.device)
            self._prefill_stage[W] = self._host(self._prefill_in[W].numel())
        parts = [("ids", ids), ("slot", [slot]), ("true_len", [S]),
                 ("seed", [req._rng_key])] + self._adapter_part(req)
        t0 = time.monotonic()
        tok = self._prefill_call(f"prefill_{W}", lambda: self._prefill_step(W),
                                 self._prefill_in[W], self._prefill_stage[W], parts)
        dt_ms = (time.monotonic() - t0) * 1e3
        self._stats.record_prefill_chunk(dt_ms, backlog=0)
        self._tracer.emit("prefill", t0, dt_ms / 1e3, trace_id=req.trace_id,
                          args={"width": W, "slot": slot})
        self._finish_prefill(req, tok)

    def _bucket(self, S: int) -> int:
        return max(min(_bucket128(S), self._chunk_limit), S)

    def _free_window_pages(self, req: Request):
        """Sliding-window page lifetime (JAX ``:2706``): page ``j`` ends at
        position ``(j+1)*P - 1``; every later query sits at ``q >= pos`` and
        attends keys ``k > q - window`` only, so once ``(j+1)*P - 1 <= pos -
        window`` the page is never read again and its reference is dropped
        (its zeroed entry gathers scratch, which the same mask excludes)."""
        pos = req._pos_base + len(req.tokens)
        row = self._table[req.slot]
        for j in range(self._pages_per_slot):
            if (j + 1) * self._page - 1 > pos - self._page_window:
                break
            if row[j]:
                self._pool.decref(int(row[j]))
                row[j] = 0
                self._window_frees += 1
            req._page_floor = j + 1

    def _prefill_call(self, name: str, step, device_in, stage, parts) -> int:
        """Run a prefill step (a chunk, or a monolithic prompt) and wait for
        its candidate first token: honest prefill timing, paced launches."""
        self._launch(name, step, device_in, stage, parts)
        self._chunk_host_out.copy_(self._chunk_out, non_blocking=True)
        self._chunk_event.record(self._stream)
        tb = time.monotonic()
        self._chunk_event.synchronize()
        self._blocked_s += time.monotonic() - tb
        return int(self._chunk_host_out[0])

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
        if self._spec_k is not None:
            return self._dispatch_spec(running, ahead)
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
        return self._launch_tick("decode", self._decode_step, live, parts)

    def _launch_tick(self, name: str, step, live, parts, lookup_hits: int = 0) -> _TickFlight:
        """Launch the tick step (decode or spec) through the tick's next
        staging buffer, start its outputs' copy home, and return its flight."""
        t0 = time.monotonic()
        buf = self._tick_buf
        self._tick_buf ^= 1
        self._launch(name, step, self._decode_in, self._decode_stage[buf], parts)
        self._decode_host_out[buf].copy_(self._decode_out.view(-1), non_blocking=True)
        event = self._decode_events[buf]
        event.record(self._stream)
        return _TickFlight([(slot, req, req._preempted) for slot, req in live], t0, buf, event,
                           lookup_hits)

    def _dispatch_spec(self, running, ahead: bool) -> Optional[_TickFlight]:
        """The speculative twin of :meth:`_dispatch` (JAX ``:3234``): launch
        one draft-and-verify tick (up to ``K + 1`` tokens a slot). Pages
        are covered up to the furthest position the slot can commit; writes
        past them go to scratch inside the step. ``ahead=True``: a stream
        with fewer than 2 tokens of budget sits out (it retires at the
        in-flight tick), coverage reaches two chains' worth of commits, and
        ``remaining`` goes in stale (never below the true budget, which the
        host's commit loop enforces)."""
        K = self._spec_k
        live = []
        for slot, req in running:
            if ahead and req.max_new_tokens - len(req.tokens) < 2:
                continue  # retires at the in-flight tick (position bound)
            if (self._emitter is not None and req.on_token is not None
                    and self._emitter.backlogged(req)):
                self._stats.record_emission_stall()
                continue
            live.append((slot, req))
        for slot, req in live:
            if req.status is not RequestStatus.RUNNING:
                continue  # preempted by an earlier slot's allocation
            rem = max(req.max_new_tokens - len(req.tokens), 1)
            span = min((2 if ahead else 1) * (K + 1), rem)
            cover = req._pos_base + len(req.tokens) + span - 1
            if not self._ensure_pages(req, cover) or (
                    self._dtable is not None and not self._ensure_draft_pages(req, cover)):
                raise RuntimeError("page pool exhausted at a speculative tick with no "
                                   "preemptable stream; the submit page bound should make "
                                   "this impossible")
        live = [(s, r) for s, r in live if r.status is RequestStatus.RUNNING]
        if not live:
            return None
        mask = np.zeros((self.max_slots,), np.int64)
        remaining = np.ones((self.max_slots,), np.int64)
        for slot, req in live:
            mask[slot] = 1
            remaining[slot] = max(req.max_new_tokens - len(req.tokens), 1)
        parts = [("active", mask), ("table", self._table)]
        if self._dtable is not None:
            parts.append(("dtable", self._dtable))
        parts.append(("remaining", remaining))
        hits = 0
        if self._spec_mode == "lookup":
            proposals = np.zeros((self.max_slots, K), np.int64)
            for slot, req in live:
                proposals[slot], hit = self._lookup_proposals(req)
                hits += int(hit)
            parts.append(("proposals", proposals))
        return self._launch_tick("spec", self._spec_step, live, parts, hits)

    def _lookup_proposals(self, req: Request):
        """Prompt-lookup drafting (JAX ``:3319``, host numpy): the ``K``
        tokens that followed the most recent earlier occurrence of the
        stream's last ``n`` tokens (prompt and committed output); on a miss
        the last token repeated, which still verifies correctly. Returns
        ``(proposal [K], hit)``."""
        K, n = self._spec_k, self._spec_lookup
        seq = np.concatenate([np.asarray(req._serve_ids[0][:req._pos_base + 1], np.int64),
                              np.asarray(req.tokens, np.int64)])
        if len(seq) > n:
            windows = np.lib.stride_tricks.sliding_window_view(seq[:-1], n)
            hits = np.nonzero((windows == seq[-n:]).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n
                prop = seq[start:start + K]
                if prop.size < K:
                    prop = np.concatenate([prop, np.full((K - prop.size,), seq[-1], np.int64)])
                return prop, True
        return np.full((K,), seq[-1], np.int64), False

    def _reconcile(self, flight: _TickFlight):
        """Settle a launched tick: wait for its tokens (the one device sync
        a tick), then commit/retire on the host. An entry whose request is
        no longer RUNNING, or whose preemption epoch moved, is a stray
        lane: its token is discarded (exactly-once emission).

        ``itl`` is the device-complete to device-complete interval;
        ``host_us_per_tick`` is that interval minus every blocked wait
        since the previous reconcile."""
        if self._wedge_s:
            # Chaos: stall inside the barrier, before the tick's sync, as a
            # replay that does not return would; no heartbeat meanwhile.
            w, self._wedge_s = self._wedge_s, 0.0
            time.sleep(w)
        tb = time.monotonic()
        flight.event.synchronize()
        spec = self._spec_k is not None
        out = self._decode_host_out[flight.buf].numpy().reshape(-1, self.max_slots).copy()
        if spec:
            emit, ns = out[:-1].T, out[-1]
        else:
            toks, dones = out[0], out[1].astype(bool)
        t1 = time.monotonic()
        self._blocked_s += t1 - tb
        if self.tick_log is not None:
            self.tick_log.append(out)
        if not self._heartbeat_frozen:
            self._heartbeat = (self._loop_iters, t1)
        prev = self._last_complete_t
        interval = t1 - (prev if prev is not None else flight.t_dispatch)
        self._last_complete_t = t1
        host_s = max(0.0, interval - self._blocked_s)
        self._blocked_s = 0.0
        committed = accepted = n_valid = 0
        for slot, req, epoch in flight.entries:
            if req.status is not RequestStatus.RUNNING or req._preempted != epoch:
                continue  # stray lane: retired/preempted since launch
            n_valid += 1
            if spec:
                # The emitted chain commits like n decode ticks: it stops at
                # max_new_tokens or the first EOS.
                n = int(ns[slot])
                accepted += n - 1
                retired = False
                for j in range(n):
                    token = int(emit[slot, j])
                    if not self._commit_token(req, token):
                        retired = True
                        break
                    committed += 1
                    if (len(req.tokens) >= req.max_new_tokens
                            or (not req.ignore_eos and self.eos_token_id is not None
                                and token == self.eos_token_id)):
                        self._retire(req, RequestStatus.COMPLETED)
                        retired = True
                        break
            else:
                if not self._commit_token(req, int(toks[slot])):
                    continue  # callback failed; slot already freed
                committed += 1
                retired = (len(req.tokens) >= req.max_new_tokens
                           or (not req.ignore_eos and bool(dones[slot])))
                if retired:
                    self._retire(req, RequestStatus.COMPLETED)
            if not retired and self._page_window is not None:
                self._free_window_pages(req)
        if spec:
            lookup = self._spec_mode == "lookup"
            self._stats.record_spec(proposed=self._spec_k * n_valid, accepted=accepted,
                                    lookup_hits=flight.lookup_hits if lookup else None,
                                    lookup_slots=n_valid if lookup else 0)
        self._decode_ticks += 1
        self._stats.record_tick(active_slots=len(flight.entries), committed_tokens=committed,
                                max_slots=self.max_slots, seconds=interval,
                                host_us=host_s * 1e6)
        tracer = self._tracer
        if tracer.enabled:
            targs = {"active": len(flight.entries), "committed": committed,
                     "host_us": round(host_s * 1e6, 1)}
            if spec:
                targs["spec_accepted"] = accepted
            tracer.emit("decode_tick", flight.t_dispatch, t1 - flight.t_dispatch, args=targs)
            for slot, req, _ in flight.entries:
                iargs = {"slot": slot, "token": len(req.tokens)}
                if spec:
                    iargs["accepted"] = int(ns[slot]) - 1
                tracer.emit("itl", t1 - interval, interval, trace_id=req.trace_id, args=iargs)
        if self._decode_ticks >= self._next_profile_tick:
            self._next_profile_tick = self._decode_ticks + 128
            self._flight.record("tick_profile", tick=self._decode_ticks,
                                itl_ms=round(interval * 1e3, 3),
                                host_us=round(host_s * 1e6, 1), active=len(flight.entries))
        if self._paged:
            self._drain_samples.append((time.monotonic(), self._pool.frees))
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
        self._release_adapter(req)
        if req.adapter is not None:
            self._stats.record_adapter_tokens(req.adapter, len(req.tokens))
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
