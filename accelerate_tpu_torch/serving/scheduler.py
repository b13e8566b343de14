"""Admission queue, slot bookkeeping, and the prefix KV block cache for
the serving engine.

Counterpart of ``accelerate_tpu/serving/scheduler.py`` (``AdmissionQueue``
``:52``, ``SlotScheduler`` ``:213``, ``PagePool`` ``:258``, ``PrefixCache``
``:323``), the same host-side structures, independent of torch:

* :class:`AdmissionQueue` — a bounded queue with backpressure: FCFS by
  default, a PRIORITY queue (strict class order, FIFO within class) when
  built with a ``rank_fn`` (see :class:`~.control.PriorityPolicy`). The
  bound is the engine's only flow control: when the queue is full,
  ``submit`` either raises :class:`QueueFull` (``block=False``) or blocks
  the caller until the engine drains a request (``block=True``), so a
  burst of traffic turns into caller-side latency instead of unbounded
  host memory.
* :class:`SlotScheduler` — a free-list over the fixed ``max_slots`` decode
  lanes. FCFS: the engine pops the oldest queued request whenever a slot
  is free. Slots are plain integers; all per-slot device state lives in
  the engine's per-slot state tensors, indexed by these.
* :class:`PrefixCache` — a byte-bounded LRU of chunk-aligned KV blocks
  keyed by the engine's prompt-prefix hash chain. The values are opaque
  here (one chunk's KV block as a tensor on the engine's device, which the
  engine's restore step copies back into a slot, or a tuple of page ids);
  the caller supplies each entry's byte size so this module stays
  torch-free.
* :class:`PagePool` — a free-list + refcount table over the paged
  engine's global KV page pool. Pages are plain integers indexing the
  device-side page arrays; refcounts exist because prefix-cache aliasing
  lets one physical page appear in several slots' page tables (and in
  the cache itself) at once. Engine-thread only, like
  :class:`SlotScheduler`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from .request import Request


class QueueFull(RuntimeError):
    """Raised by non-blocking submit when the admission queue is at bound."""


class QueueClosed(RuntimeError):
    """Raised by ``put`` when the engine behind the queue has stopped — the
    request can never be served, so the caller (blocked or not) is woken
    with this instead of enqueueing onto (or hanging against) a dead
    engine."""


class AdmissionQueue:
    """Bounded request queue (thread-safe; many producers, one engine
    consumer). FCFS by default; pass ``rank_fn`` to make it a PRIORITY
    queue — strict rank order across classes (lower rank pops first,
    so interactive traffic admits ahead of queued batch work), FIFO
    within each class.

    Built on a condition pair rather than ``queue.Queue`` so the consumer
    can :meth:`close` it: a producer blocked in ``put(block=True)`` against
    a full queue is woken with :class:`QueueClosed` the moment the engine
    stops, instead of sleeping forever on space that will never free.

    Args:
      max_queued: the bound (the engine's only flow control).
      rank_fn: maps a request's ``priority`` (a string or None) to an
        integer rank, 0 = most important — typically
        :meth:`~.control.PriorityPolicy.rank`. ``None`` (default) ranks
        everything equal, which is exactly the old FCFS behavior.
    """

    def __init__(self, max_queued: int = 64, rank_fn=None):
        if max_queued < 1:
            raise ValueError(f"max_queued must be >= 1 (got {max_queued})")
        self.max_queued = int(max_queued)
        self._rank_fn = rank_fn
        # rank -> FIFO deque; gets scan ranks ascending. With rank_fn=None
        # everything lands in bucket 0 and this IS a plain FIFO deque.
        self._buckets: dict[int, collections.deque[Request]] = {}
        self._n = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._pending_tokens = 0

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pending_tokens(self) -> int:
        """Projected token footprint (prompt + max_new) summed over every
        queued request — the admission-side half of the gateway's
        projected-pressure shed signal. For a preempted request requeued
        by ``putleft`` this over-counts by the tokens it already emitted;
        pressure estimates only need an upper bound."""
        return self._pending_tokens

    @staticmethod
    def _footprint(request: Request) -> int:
        # Tolerate non-Request items: lifecycle unit tests (and any future
        # sentinel objects) flow through the queue without a footprint.
        try:
            return (int(request.prompt_ids.shape[1])
                    + int(request.max_new_tokens))
        except AttributeError:
            return 0

    def _rank_of(self, request) -> int:
        if self._rank_fn is None:
            return 0
        return int(self._rank_fn(getattr(request, "priority", None)))

    def _bucket(self, rank: int) -> collections.deque:
        bucket = self._buckets.get(rank)
        if bucket is None:
            bucket = self._buckets[rank] = collections.deque()
        return bucket

    def put(self, request: Request, block: bool = True,
            timeout: Optional[float] = None):
        """Enqueue; raises :class:`QueueFull` on backpressure (immediately
        when ``block=False``, after ``timeout`` otherwise) and
        :class:`QueueClosed` — immediately, or mid-wait — once the engine
        has stopped."""
        with self._lock:
            deadline = None if timeout is None else time.monotonic() + timeout
            while True:
                if self._closed:
                    raise QueueClosed(
                        "serving engine stopped; the admission queue is "
                        "closed and will never drain")
                if self._n < self.max_queued:
                    self._bucket(self._rank_of(request)).append(request)
                    self._n += 1
                    self._pending_tokens += self._footprint(request)
                    self._not_empty.notify()
                    return
                if not block:
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                self._not_full.wait(remaining)
            raise QueueFull(
                f"admission queue full ({self.max_queued} requests queued); "
                "retry later or submit with block=True")

    def putleft(self, request: Request):
        """Requeue at the FRONT of the request's class, bypassing the
        bound — the paged engine's preemption path: a request evicted
        from its slot on pool exhaustion goes back ahead of everything
        younger IN ITS CLASS (it was admitted first; within-class FCFS
        order is preserved, not reset — but it never jumps a class the
        priority policy ranks above it), and it must never bounce off a
        momentarily-full queue it already passed through."""
        with self._lock:
            if self._closed:
                raise QueueClosed(
                    "serving engine stopped; the admission queue is "
                    "closed and will never drain")
            self._bucket(self._rank_of(request)).appendleft(request)
            self._n += 1
            self._pending_tokens += self._footprint(request)
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Pop the best-ranked oldest request, or None after ``timeout``
        (engine poll). Close does not interrupt gets — the engine keeps
        draining what is already queued during shutdown."""
        with self._lock:
            if not self._n and timeout is not None and timeout > 0:
                self._not_empty.wait(timeout)
            if not self._n:
                return None
            for rank in sorted(self._buckets):
                bucket = self._buckets[rank]
                if bucket:
                    item = bucket.popleft()
                    break
            self._n -= 1
            self._pending_tokens -= self._footprint(item)
            self._not_full.notify()
            return item

    def get_nowait(self) -> Optional[Request]:
        return self.get()

    def close(self):
        """Mark the queue dead (engine stopped) and wake every producer
        blocked in ``put`` with :class:`QueueClosed`. Items already queued
        stay poppable so the shutdown path can drain and finish them."""
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def __len__(self) -> int:
        return self._n

    def drain(self) -> list[Request]:
        """Remove and return everything currently queued (shutdown path)."""
        out = []
        while True:
            r = self.get_nowait()
            if r is None:
                return out
            out.append(r)


class SlotScheduler:
    """Free-list of decode slots + the request occupying each.

    Engine-thread only (no lock): admission, retirement, and the tick loop
    all run on the single engine thread.
    """

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1 (got {max_slots})")
        self.max_slots = int(max_slots)
        self._free = collections.deque(range(self.max_slots))
        self._occupant: dict[int, Request] = {}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return len(self._occupant)

    def has_free(self) -> bool:
        return bool(self._free)

    def assign(self, request: Request) -> int:
        slot = self._free.popleft()  # lowest-index-first keeps state compact
        self._occupant[slot] = request
        request.slot = slot
        return slot

    def release(self, slot: int) -> Request:
        request = self._occupant.pop(slot)
        request.slot = None
        self._free.append(slot)
        return request

    def occupant(self, slot: int) -> Optional[Request]:
        return self._occupant.get(slot)

    def active(self) -> list[tuple[int, Request]]:
        """(slot, request) pairs for every occupied slot, slot-ordered."""
        return sorted(self._occupant.items())


class PagePool:
    """Free-list + refcounts over the paged engine's fixed-size KV pages.

    Page ids are ``1..num_pages``; page ``0`` is the engine's reserved
    scratch page (never allocated — the engine's steps route writes of
    released or not-yet-allocated slots there, so it holds garbage by
    design and is excluded from accounting here). A page's refcount is
    the number of owners keeping it alive: each slot whose page table
    holds it counts one, and a prefix-cache alias entry counts one more —
    the page returns to the free list only when the LAST owner drops it.
    Engine-thread only (no lock), like :class:`SlotScheduler`.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1 (got {num_pages})")
        self.num_pages = int(num_pages)
        self._free: collections.deque[int] = collections.deque(
            range(1, self.num_pages + 1))
        self._ref = [0] * (self.num_pages + 1)
        self.allocations = 0
        self.preemptions = 0  # billed by the engine when exhaustion preempts
        self.frees = 0  # pages returned to the free list (drain-rate input)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self) -> Optional[int]:
        """Pop one free page (refcount 1), or None when the pool is
        exhausted — the engine then reclaims alias-held pages or preempts
        a slot; allocation itself never blocks or raises."""
        if not self._free:
            return None
        page = self._free.popleft()
        self._ref[page] = 1
        self.allocations += 1
        return page

    def incref(self, page: int):
        """One more owner for an allocated page (prefix aliasing: a cache
        entry, or a second slot's table row, now also points at it)."""
        if page <= 0 or self._ref[page] <= 0:
            raise ValueError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one owner; returns True when this freed the page."""
        if page <= 0 or self._ref[page] <= 0:
            raise ValueError(f"decref of unallocated page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            self.frees += 1
            return True
        return False

    def refcount(self, page: int) -> int:
        return self._ref[page]


class PrefixCache:
    """Byte-bounded LRU of chunk-aligned prefix KV blocks.

    Keys are hash-chain digests: the engine hashes each chunk's tokens
    TOGETHER with the previous chunk's digest, so a key identifies the
    entire token prefix up to and including its chunk — two prompts share
    an entry exactly when they share that whole chunk-aligned prefix.
    Values are opaque (one chunk's KV block for every layer, a tensor on
    the engine's device, or a tuple of page ids for a paged engine's
    private cache); the engine passes each block's byte size into
    :meth:`put` so accounting stays torch-free here.

    Thread-safe: unlike :class:`SlotScheduler`, one instance may be shared
    by every slice of a ``ReplicaSet.from_mesh`` fleet (each slice engine
    reads and writes from its own engine thread), so a prefix one slice
    prefilled is a hit on any other — including the failover resume path.
    The lock covers each operation; blocks themselves are immutable once
    inserted.
    """

    def __init__(self, capacity_bytes: int, on_evict=None):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1 (got {capacity_bytes}); "
                "disable prefix caching at the engine instead")
        self.capacity_bytes = int(capacity_bytes)
        # key -> (block, nbytes); insertion order == LRU order (move_to_end
        # on every touch), so eviction pops from the front.
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._bytes = 0
        self.insertions = 0
        self.evictions = 0
        self.oversize_rejects = 0
        #: ``on_evict(key, block)`` fires (lock held) whenever an entry
        #: leaves the cache — eviction, reclaim, or clear. The paged engine
        #: uses it to drop the PagePool refs its alias entries hold; the
        #: default copy-block cache needs no hook.
        self._on_evict = on_evict

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def match(self, keys) -> list:
        """Blocks for the longest cached prefix of ``keys``, in chain order
        (each hit is touched most-recently-used). Stops at the first miss:
        a later chunk's KV is only valid on top of every earlier one."""
        out = []
        with self._lock:
            for key in keys:
                entry = self._entries.get(key)
                if entry is None:
                    break
                self._entries.move_to_end(key)
                out.append(entry[0])
        return out

    def longest_prefix(self, keys) -> int:
        """How many leading ``keys`` are resident, WITHOUT touching LRU
        order or refcounts — the cheap probe behind prefix-cache-aware
        routing (:meth:`~.router.ReplicaSet._candidates` calls it per
        candidate replica per routing decision, so it must not promote
        entries a request may never actually restore). Stops at the
        first miss for the same chain reason :meth:`match` does."""
        n = 0
        with self._lock:
            for key in keys:
                if key not in self._entries:
                    break
                n += 1
        return n

    def put(self, key, block, nbytes: int) -> bool:
        """Insert one chunk's block (touch if already present), then evict
        least-recently-used entries until within capacity. A block larger
        than the whole capacity is rejected outright — admitting it would
        evict EVERY resident entry and still not fit, so the cache keeps
        what it has and counts the reject instead. Returns True only when
        the block was actually inserted (the paged engine pins page refs
        per INSERTED entry, so touch/reject must be distinguishable)."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            nbytes = int(nbytes)
            if nbytes > self.capacity_bytes:
                self.oversize_rejects += 1
                return False
            self._entries[key] = (block, nbytes)
            self._bytes += nbytes
            self.insertions += 1
            while self._bytes > self.capacity_bytes:
                self._pop_lru_locked()
            return True

    def _pop_lru_locked(self):
        key, (block, nb) = self._entries.popitem(last=False)
        self._bytes -= nb
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(key, block)

    def evict_lru(self) -> bool:
        """Force out the least-recently-used entry (False when empty) —
        the paged engine's reclaim path: alias-held pages are freed
        cache-entry by cache-entry until an allocation succeeds, BEFORE
        any running request gets preempted."""
        with self._lock:
            if not self._entries:
                return False
            self._pop_lru_locked()
            return True

    def entries(self) -> list:
        """(key, block) snapshot in LRU order (reclaimability accounting:
        the paged engine counts pages whose only owner is the cache)."""
        with self._lock:
            return [(k, b) for k, (b, _) in self._entries.items()]

    def clear(self):
        """Drop every entry (engine warmup runs dummy prompts through the
        normal path; their blocks must not linger as phantom prefixes)."""
        with self._lock:
            if self._on_evict is not None:
                for key, (block, _) in self._entries.items():
                    self._on_evict(key, block)
            self._entries.clear()
            self._bytes = 0
            self.insertions = 0
            self.evictions = 0
            self.oversize_rejects = 0
