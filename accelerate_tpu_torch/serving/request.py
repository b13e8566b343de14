"""Request objects for the serving engine.

Counterpart of ``accelerate_tpu/serving/request.py``.

A :class:`Request` is both the admission record the engine schedules and
the HANDLE the caller keeps: ``submit()`` returns it immediately, tokens
stream into it (and through ``on_token``) as they are committed, and
``result()`` blocks until the request retires. All mutation after submit
happens on the engine thread; the caller only reads, waits, or flips the
cancel flag — so the only synchronization needed is the done event and a
couple of volatile flags.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Optional

import numpy as np


class RequestStatus(enum.Enum):
    QUEUED = "queued"        # submitted, waiting for a slot
    PREFILLING = "prefilling"  # holds a slot; prompt chunks still running
    RUNNING = "running"      # prefilled into a slot, decoding
    COMPLETED = "completed"  # emitted eos or max_new_tokens
    FAILED = "failed"        # admission/callback error (slot freed, batch unharmed)
    CANCELLED = "cancelled"  # cancel() honored (or engine shutdown without drain)
    TIMED_OUT = "timed_out"  # per-request deadline passed while queued or running


_TERMINAL = (RequestStatus.COMPLETED, RequestStatus.FAILED,
             RequestStatus.CANCELLED, RequestStatus.TIMED_OUT)


class Request:
    """One generation request: prompt + per-request knobs + result handle.

    Sampling parameters (greedy vs temperature/top-k/top-p) and the eos id
    are ENGINE-level — they are fixed in the captured step graphs, so a
    per-request change would mean a new capture; what varies per request is
    everything host-side: ``max_new_tokens``, ``timeout``, the rng key, the
    streaming callback, and cancellation.
    """

    def __init__(self, prompt_ids, max_new_tokens: int = 20,
                 rng=None, seed: Optional[int] = None,
                 timeout: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 ignore_eos: bool = False,
                 adapter: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 priority: Optional[str] = None):
        ids = np.asarray(prompt_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        if ids.ndim != 2 or ids.shape[0] != 1:
            raise ValueError(
                f"prompt_ids must be [S] or [1, S] (got shape {ids.shape}); "
                "the engine schedules requests individually into slots")
        self.prompt_ids = ids
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1 (got {max_new_tokens})")
        self.rng = rng
        self.seed = seed
        self.timeout = timeout
        self.on_token = on_token
        #: run to exactly max_new_tokens even if eos is emitted (warmup and
        #: benchmark traffic — keeps tick counts deterministic).
        self.ignore_eos = ignore_eos
        if adapter is not None and (not isinstance(adapter, str) or not adapter):
            raise ValueError(
                f"adapter must be a non-empty string or None (got {adapter!r})")
        #: named LoRA adapter this request decodes under (None = base model).
        self.adapter = adapter
        if trace_id is not None and (not isinstance(trace_id, str) or not trace_id):
            raise ValueError(
                f"trace_id must be a non-empty string or None (got {trace_id!r})")
        #: correlation id carried through every lifecycle edge (gateway-minted
        #: or client-supplied); engine spans and the SSE done-summary tag it.
        self.trace_id = trace_id
        if priority is not None and (not isinstance(priority, str)
                                     or not priority):
            raise ValueError(
                f"priority must be a non-empty string or None (got {priority!r})")
        #: client-declared traffic class (e.g. ``"interactive"``/``"batch"``).
        #: With the engine's default :class:`~.control.PriorityPolicy` this
        #: is ACTED ON: admission is a priority queue (FIFO within class)
        #: and pool-exhaustion preemption evicts the lowest class first.
        #: It also labels tracer spans and per-priority metrics series.
        #: Engines built with ``priority_policy=None`` fall back to the
        #: historical measurement-only FCFS behaviour.
        self.priority = priority

        self.tokens: list[int] = []        # committed tokens, streamed order
        self.status = RequestStatus.QUEUED
        self.error: Optional[BaseException] = None
        self.slot: Optional[int] = None

        self.submitted_at: Optional[float] = None   # engine-stamped (monotonic)
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None

        self._cancel_requested = False
        self._done = threading.Event()
        # True once the terminal transition ran (engine thread). Under the
        # async host runtime the OBSERVABLE completion (``_done`` /
        # ``_on_finish``) may lag this flag: the engine sets status/error
        # synchronously via ``_finish(..., defer=True)`` and the emitter
        # thread calls ``_complete()`` only after every buffered ``on_token``
        # callback for this request has drained — the drain-on-retire
        # barrier that keeps ``result()`` ordered after the last callback.
        self._finished = False
        # Off-thread emission bookkeeping (engine + emitter threads; the
        # int is GIL-atomic enough for flow control): callbacks queued but
        # not yet run, and the first exception an ``on_token`` raised on
        # the emitter thread (the engine's loop-top sweep retires on it).
        self._emit_pending = 0
        self._emit_error: Optional[BaseException] = None
        # Internal completion hook (router layer): called ON THE ENGINE
        # THREAD exactly once, right after the terminal transition — the
        # ReplicaSet uses it to fail a dead replica's in-flight requests
        # over to a healthy one without polling.
        self._on_finish: Optional[Callable[["Request"], None]] = None

        # Chunked-prefill bookkeeping (engine thread only): the per-request
        # sampling seed is fixed at admission (``seed``, or ``rng`` given as
        # an int; 0 when neither is set) because every draw is keyed by it
        # and the drawn token's position; ``_next_chunk`` is the prefill
        # frontier in chunk units.
        self._rng_key = None
        self._next_chunk = 0
        self._chunks_total = 0
        self._chunk_keys: Optional[list] = None

        # Adapter bookkeeping (engine thread only): the bank row this
        # request gathers, and whether it holds a residency pin that
        # _retire must release.
        self._adapter_row = 0
        self._adapter_pinned = False

        # Paged-engine bookkeeping (engine thread only). ``_serve_ids`` is
        # the token sequence admission actually prefills — the prompt, or
        # prompt + tokens-emitted-so-far after a pool-exhaustion
        # preemption (the same resume-as-longer-prompt trick the router's
        # failover uses: for greedy decoding the resumed prefill's
        # first-token pick IS the interrupted decode step, bit-exact).
        self._serve_ids = None
        self._preempted = 0  # times evicted by pool exhaustion
        # Host mirror of the device write position: after prefill the
        # engine sets this so that ``_pos_base + len(tokens)`` is always
        # the slot's next KV write position (page-coverage checks).
        self._pos_base = 0
        # Lowest table index that may still be live: sliding-window page
        # freeing advances it so re-coverage never re-allocates pages the
        # window already retired (reset to 0 on every (re)admission).
        self._page_floor = 0

    # -- caller API -----------------------------------------------------
    def cancel(self):
        """Request cancellation: a queued request is dropped before it ever
        takes a slot; a prefilling or running request retires at the next
        scheduler pass (its slot frees without disturbing the rest of the
        batch, and no further prefill chunks are spent on it)."""
        self._cancel_requested = True

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request retires; True if it did within timeout."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Generated token ids [n] (prompt excluded), blocking until done.

        Raises ``TimeoutError`` if the wait times out, or ``RuntimeError``
        (chaining the recorded error, if any) when the request did not
        complete — failed, cancelled, or deadline-expired.
        """
        if not self._done.wait(timeout):
            raise TimeoutError("request still in flight")
        if self.status != RequestStatus.COMPLETED:
            raise RuntimeError(
                f"request {self.status.value}"
                + (f": {self.error}" if self.error is not None else "")
            ) from self.error
        return np.asarray(self.tokens, np.int32)

    def output_ids(self, timeout: Optional[float] = None) -> np.ndarray:
        """[1, S + n] prompt + completion — the offline ``generate`` shape."""
        toks = self.result(timeout)
        return np.concatenate([self.prompt_ids, toks[None, :]], axis=1)

    # -- engine internals ----------------------------------------------
    def _deadline_passed(self, now: Optional[float] = None) -> bool:
        if self.timeout is None or self.submitted_at is None:
            return False
        return (now if now is not None else time.monotonic()) \
            > self.submitted_at + self.timeout

    def _finish(self, status: RequestStatus, error: Optional[BaseException] = None,
                defer: bool = False):
        """Terminal transition. ``defer=True`` (async engines, streaming
        requests) records status/error immediately — so the engine thread
        sees a consistent terminal state for scheduling — but leaves the
        observable completion (:meth:`_complete`) to the emitter thread,
        AFTER this request's buffered callbacks drain. Returns True when
        this call performed the transition (callers that defer must queue
        the completion exactly once)."""
        if self._finished:  # first terminal transition wins
            return False
        self._finished = True
        self.status = status
        self.error = error
        if not defer:
            self._complete()
        return True

    def _complete(self):
        """Second half of the terminal transition: stamp, wake waiters,
        fire the router hook. Runs on the engine thread (sync path) or the
        emitter thread (deferred path) — exactly once either way."""
        self.finished_at = time.monotonic()
        self._done.set()
        if self._on_finish is not None:
            try:
                self._on_finish(self)
            except Exception:
                # The hook belongs to the router layer; a raising hook must
                # not take down the thread finishing the request.
                pass

    def __repr__(self):
        return (f"Request(S={self.prompt_ids.shape[1]}, "
                f"max_new={self.max_new_tokens}, status={self.status.value}, "
                f"tokens={len(self.tokens)})")
