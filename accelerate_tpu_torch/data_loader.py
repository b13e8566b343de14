"""Data loading: index samplers, loaders sharded across processes,
resume, packing, and batches on the device.

Counterpart of ``accelerate_tpu/data_loader.py``: ``SeedableRandomSampler``
(``:51``), ``BatchSamplerShard`` (``:79``), ``IterableDatasetShard``
(``:199``), ``default_collate`` (``:275``), ``make_global_batch``
(``:296``), ``AsyncPrefetcher`` (``:373``), ``DataLoaderStateMixin``
(``:516``), ``DataLoaderShard`` (``:550``), ``DataLoaderDispatcher``
(``:785``), ``NumpyDataLoader`` (``:881``), ``prepare_data_loader``
(``:979``), ``_reshard_torch_dataloader`` (``:1072``), ``SkipBatchSampler``
/ ``SkipDataLoader`` / ``skip_first_batches`` (``:1099-1150``) and
``pack_sequences`` (``:1152``).

What differs from the JAX package: there is no mesh. Each process reads
its own shard of every global batch (or, dispatched, receives its slice
of what the main process read) and places it on its own device. On
``cuda`` a batch is staged through pinned host memory with a
``non_blocking`` copy on a side stream; the training stream waits on the
copy's event and records the tensors' use (``record_stream``) before it
reads them, so the caching allocator never hands the buffers out while
they are in use.
"""

from __future__ import annotations

import bisect
import copy
import math
import queue as queue_lib
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .logging import get_logger
from .state import GradientState, PartialState
from .utils.device import resolve_device
from .utils.operations import find_batch_size, recursively_apply
from .utils.profiling import PipelineStats

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

class SeedableRandomSampler:
    """Random order that depends on (seed, epoch) only: numpy's generator
    seeded with the pair, as in the JAX package, so both give the same
    order."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def __len__(self):
        return self.data_source_len

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng([self.seed, self.epoch])
        yield from rng.permutation(self.data_source_len).tolist()


class BatchSamplerShard:
    """This process's index batches of an inner batch sampler: with
    ``split_batches`` a slice of every batch, else every
    ``num_processes``-th batch; ``even_batches`` completes the last round
    by cycling from the start. On one process it yields the inner batches
    unchanged."""

    def __init__(self, batch_sampler: Iterable[list[int]], num_processes: int = 1,
                 process_index: int = 0, split_batches: bool = False, even_batches: bool = True):
        if split_batches:
            bs = getattr(batch_sampler, "batch_size", None)
            if bs is not None and bs % num_processes != 0:
                raise ValueError(
                    f"split_batches=True requires the batch size to divide evenly across "
                    f"processes, but {bs} is not divisible by {num_processes}.")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        if self.split_batches:
            return len(self.batch_sampler)
        if len(self.batch_sampler) % self.num_processes == 0:
            return len(self.batch_sampler) // self.num_processes
        length = len(self.batch_sampler) // self.num_processes
        if self.drop_last:
            return length
        if self.even_batches:
            return length + 1
        return length + 1 if self.process_index < len(self.batch_sampler) % self.num_processes \
            else length

    def __iter__(self):
        return self._iter_with_split() if self.split_batches else self._iter_with_no_split()

    def _iter_with_split(self):
        initial_data, chunk_size = [], None
        for idx, batch in enumerate(self.batch_sampler):
            if idx == 0:
                initial_data = list(batch)
                chunk_size = len(batch) // self.num_processes
            lo, hi = chunk_size * self.process_index, chunk_size * (self.process_index + 1)
            if len(batch) == chunk_size * self.num_processes:
                yield batch[lo:hi]
            elif not self.even_batches:
                if len(batch[lo:hi]) > 0:
                    yield batch[lo:hi]
            else:
                target = chunk_size * self.num_processes
                pad_src = initial_data if initial_data else list(batch)
                batch = list(batch)
                while len(batch) < target:
                    batch += pad_src[: target - len(batch)]
                yield batch[lo:hi]

    def _iter_with_no_split(self):
        initial_data: list = []
        current_round: list[list] = []
        idx = -1
        for idx, batch in enumerate(self.batch_sampler):
            if not self.drop_last and idx < self.num_processes:
                initial_data += batch
            current_round.append(batch)
            if idx % self.num_processes == self.num_processes - 1:
                if self.batch_size is None or len(batch) == self.batch_size:
                    yield current_round[self.process_index]
                    current_round = []
        if self.drop_last or idx < 0 or not current_round:
            return
        if not self.even_batches:
            if len(current_round) > self.process_index and len(current_round[self.process_index]):
                yield current_round[self.process_index]
            return
        bs = self.batch_size if self.batch_size is not None else len(current_round[0])
        flat = [i for b in current_round for i in b]
        pad_src = initial_data if initial_data else list(flat)
        while len(flat) < bs * self.num_processes:
            flat += pad_src[: bs * self.num_processes - len(flat)]
        yield flat[bs * self.process_index: bs * (self.process_index + 1)]


class IterableDatasetShard(torch.utils.data.IterableDataset):
    """This process's items of an iterable dataset: it buffers a global
    batch (``batch_size * num_processes`` items, or ``batch_size`` with
    ``split_batches``) and yields this process's slice of it. Without
    ``drop_last`` the last global batch is completed by cycling from the
    first one."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False):
        if split_batches and batch_size % num_processes != 0:
            raise ValueError(f"split_batches=True needs the batch size ({batch_size}) to "
                             f"divide evenly across {num_processes} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        rounds = len(self.dataset) / (self.batch_size * self.num_processes)
        return (math.floor(rounds) if self.drop_last else math.ceil(rounds)) * self.batch_size

    def __iter__(self):
        real = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        per = self.batch_size // self.num_processes if self.split_batches else self.batch_size
        mine = range(self.process_index * per, (self.process_index + 1) * per)
        first, current = None, []
        for element in self.dataset:
            current.append(element)
            if len(current) == real:
                yield from (current[i] for i in mine)
                first = current if first is None else first
                current = []
        if not self.drop_last and current:
            first = list(current) if first is None else first
            while len(current) < real:
                current += first
            yield from (current[i] for i in mine)


class BatchSamplerFromSampler:
    """A sampler's indices grouped into batches."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        batch = []
        for i in self.sampler:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


# ---------------------------------------------------------------------------
# Collation and device batches
# ---------------------------------------------------------------------------

def default_collate(samples: list[Any]):
    """A list of samples (nested dicts/lists of arrays) stacked into one
    numpy batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def _host_tensor(x) -> torch.Tensor:
    """A leaf as a CPU tensor of the batch dtype: integers int64 (token ids
    index an embedding), floating point float32, booleans bool."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
    else:
        array = np.asarray(x)
        if not (array.dtype == np.bool_ or np.issubdtype(array.dtype, np.integer)
                or np.issubdtype(array.dtype, np.floating)):
            raise TypeError(f"make_global_batch takes numeric arrays, got {array.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(array))
    if t.dtype == torch.bool:
        return t
    if t.is_floating_point():
        return t.to(torch.float32)
    if t.is_complex():
        raise TypeError(f"make_global_batch takes real arrays, got {t.dtype}")
    return t.to(torch.int64)


def _any_leaf(x) -> bool:
    return True


def _device_of(device) -> torch.device:
    if not isinstance(device, (str, torch.device)) and hasattr(device, "device"):
        device = device.device  # an Accelerator
    return resolve_device(device)


def batch_sharding(mesh):
    """The spec of a batch on ``mesh``: its rows split over the batch axes
    (``dp`` x ``fsdp``, ``BATCH_AXES``); the ``tp``, ``cp`` and ``pp``
    processes of one data shard read the same rows."""
    from .parallel.sharding import PartitionSpec
    from .utils.constants import BATCH_AXES

    return PartitionSpec(tuple(ax for ax in BATCH_AXES if ax in mesh.shape))


def _data_shard(mesh, sharding=None) -> tuple:
    """``(index, count)`` of this process's data shard on ``mesh`` by the
    axes ``sharding`` splits dim 0 over (default :func:`batch_sharding`)."""
    spec = sharding if sharding is not None else batch_sharding(mesh)
    axes = spec[0] if len(spec) else ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return mesh.index(axes), mesh.size(axes)


def make_global_batch(local_batch, device=None, mesh=None, sharding=None):
    """A dict (or list/tuple) of numpy arrays or tensors, nested or not, as
    tensors on ``device``: an ``Accelerator`` (its device), a device, or
    None (``cuda``, which raises without a card). Integer leaves become
    int64, floating ones float32, booleans stay bool.

    Without ``mesh`` the batch is this process's rows. With a ``mesh``
    (the JAX package's one-process form) ``local_batch`` is the global
    batch, the same on every process, and each keeps its data shard's
    rows: dim 0 split over the axes of ``sharding`` (default
    :func:`batch_sharding`); a leaf without a divisible dim 0 stays
    whole."""
    device = _device_of(device)
    index, count = _data_shard(mesh, sharding) if mesh is not None else (0, 1)

    def one(x):
        t = _host_tensor(x)
        if count > 1 and t.dim() > 0 and t.shape[0] % count == 0:
            k = t.shape[0] // count
            t = t[index * k:(index + 1) * k]
        return t.to(device)

    return recursively_apply(one, local_batch, test_type=_any_leaf)


class _Staged:
    """A batch copied to the card on the staging stream, and the event that
    marks the copy's end."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device):
        self.batch = batch
        self.event = event
        self.device = device

    def ready(self):
        """The batch, safe to read on the current stream."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        recursively_apply(lambda t: t.record_stream(stream), self.batch)
        return self.batch


class _Stager:
    """Stages host batches on ``device``: on ``cuda`` through pinned memory
    and a side stream (``non_blocking``), else by a plain copy."""

    def __init__(self, device: torch.device, non_blocking: bool = True):
        self.device = device
        self.pinned = device.type == "cuda" and non_blocking
        self._stream = None

    def __call__(self, batch):
        host = recursively_apply(_host_tensor, batch, test_type=_any_leaf)
        if not self.pinned:
            return recursively_apply(lambda t: t.to(self.device), host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = recursively_apply(
                lambda t: t.pin_memory().to(self.device, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(out, event, self.device)


def _ready(staged):
    return staged.ready() if isinstance(staged, _Staged) else staged


# ---------------------------------------------------------------------------
# Asynchronous prefetch
# ---------------------------------------------------------------------------

class _EndOfStream:
    """Queue sentinel: the producer exhausted its source."""


_END = _EndOfStream()


class _PipelineError:
    """Queue envelope carrying a producer's exception to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Done:
    """An already staged batch, shaped like a future."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class AsyncPrefetcher:
    """Background input pipeline: one thread pulls ``produce()`` (fetch and
    collate), stages each batch (``stage``) and parks up to
    ``prefetch_size`` staged batches in a bounded queue, while the training
    thread runs its step.

    ``num_workers > 1`` stages on a thread pool, the queue holding futures
    in pull order. A producer's exception is re-raised by :meth:`get`.
    ``close()`` is idempotent: it wakes a blocked producer, joins the
    thread and shuts the pool down."""

    def __init__(self, produce: Callable[[], Any], stage: Callable[[Any], Any],
                 prefetch_size: int = 2, num_workers: int = 1,
                 stats: Optional[PipelineStats] = None):
        self._produce = produce
        self._stage = stage
        self._stats = stats
        self._queue: queue_lib.Queue = queue_lib.Queue(maxsize=max(1, prefetch_size))
        self._stop = threading.Event()
        self._closed = False
        self._executor = ThreadPoolExecutor(max_workers=num_workers,
                                            thread_name_prefix="atpu-stage") \
            if num_workers > 1 else None
        self._thread = threading.Thread(target=self._run, name="atpu-prefetch", daemon=True)
        self._thread.start()

    def _timed_stage(self, raw):
        t0 = time.perf_counter()
        out = self._stage(raw)
        if self._stats is not None:
            self._stats.record_stage((time.perf_counter() - t0) * 1e3)
        return out

    def _put(self, item) -> bool:
        # A put that stays responsive to close(): a plain put would block
        # forever against a consumer that left.
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue_lib.Full:
                continue
        return False

    def _run(self):
        try:
            while not self._stop.is_set():
                try:
                    raw = self._produce()
                except StopIteration:
                    break
                if self._executor is not None:
                    item = self._executor.submit(self._timed_stage, raw)
                else:
                    item = _Done(self._timed_stage(raw))
                if not self._put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 - forwarded to the consumer
            self._put(_PipelineError(exc))
            return
        self._put(_END)

    def get(self):
        """The next staged batch in source order. Raises ``StopIteration``
        at the end and re-raises a producer's exception."""
        t0 = time.perf_counter()
        item = self._queue.get()
        if isinstance(item, _PipelineError):
            self._stop.set()
            raise item.exc
        if item is _END:
            raise StopIteration
        batch = item.result()  # blocks only while a pool worker still stages it
        if self._stats is not None:
            self._stats.record_wait((time.perf_counter() - t0) * 1e3)
            self._stats.record_depth(self._queue.qsize())
        return batch

    def close(self):
        """Stop the worker and release the pipeline (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue_lib.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            logger.warning("atpu-prefetch worker still alive 5 s after close(): a produce or "
                           "stage call is hung, and it keeps consuming the source until it "
                           "returns.", main_process_only=False)
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)

    def __del__(self):  # pragma: no cover - depends on when the GC runs
        self.close()


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

class DataLoaderStateMixin:
    """Tracks ``end_of_dataloader`` and ``remainder`` and registers the
    loader with ``GradientState`` while it iterates."""

    def __init_subclass__(cls, **kwargs):
        cls.end_of_dataloader = False
        cls.remainder = -1

    def reset(self):
        self.end_of_dataloader = False
        self.remainder = -1

    def begin(self):
        """Register with GradientState and work out the last batch's
        remainder (-1 for an unsized source)."""
        self.reset()
        length = self.total_dataset_length
        if length is not None:
            self.remainder = length % self.total_batch_size
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)


class DataLoaderShard(DataLoaderStateMixin):
    """A prepared loader: iterates any source of host batches (nested numpy
    arrays or tensors) and yields them as tensors on ``device``.

    * It runs one batch ahead, so ``end_of_dataloader`` (and a sync of the
      gradients) is set before the last batch is yielded.
    * With ``async_prefetch`` a background thread pulls, collates and
      stages ``prefetch_size`` batches ahead of the training thread
      (:class:`AsyncPrefetcher`); else the same lookahead runs inline.
    * ``data_wait_ms``, ``stage_ms`` and the queue depth go to
      :attr:`pipeline_stats` in both modes.
    * ``state_dict``/``load_state_dict`` hold the resume position (epoch and
      batches yielded in it).
    * In a process group, each epoch starts by giving every process the
      main process's ``rng_types`` streams (and ``synchronized_generator``),
      so shuffles agree."""

    def __init__(self, base_dataloader: Iterable, device=None, skip_batches: int = 0,
                 prefetch_size: int = 2, total_batch_size: Optional[int] = None,
                 dataset_length: Optional[int] = None, stage_to_device: bool = True,
                 async_prefetch: bool = True, num_workers: int = 1, non_blocking: bool = True,
                 rng_types: Optional[list] = None, synchronized_generator=None, mesh=None,
                 device_sharding=None):
        self.base_dataloader = base_dataloader
        self.mesh = mesh
        self.device_sharding = device_sharding
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self.device = resolve_device(device) if stage_to_device else None
        self.skip_batches = skip_batches
        self.prefetch_size = max(1, prefetch_size)
        self.async_prefetch = async_prefetch
        self.num_workers = max(1, num_workers)
        self.stage_to_device = stage_to_device
        self.non_blocking = non_blocking
        self.gradient_state = GradientState()
        self.pipeline_stats = PipelineStats()
        self._total_batch_size = total_batch_size
        self._dataset_length = dataset_length
        self._stager = _Stager(self.device, non_blocking) if stage_to_device else None
        self.iteration = 0          # epoch counter
        self.batches_consumed = 0   # yielded in the current epoch, for resume

    @property
    def dataset(self):
        return getattr(self.base_dataloader, "dataset", None)

    @property
    def batch_size(self):
        return getattr(self.base_dataloader, "batch_size", None)

    @property
    def total_batch_size(self):
        if self._total_batch_size is not None:
            return self._total_batch_size
        bs = self.batch_size
        if bs is None:
            bs = getattr(getattr(self.base_dataloader, "batch_sampler", None), "batch_size", None)
        shards = (self.mesh.data_shards() if self.mesh is not None
                  else PartialState().num_processes)
        return (bs or 1) * shards

    @property
    def total_dataset_length(self):
        if self._dataset_length is not None:
            return self._dataset_length
        try:
            return len(self.dataset)
        except TypeError:
            return None

    def set_epoch(self, epoch: int):
        """Reseed the samplers for ``epoch``."""
        self.iteration = epoch
        sampler = getattr(self.base_dataloader, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        batch_sampler = getattr(self.base_dataloader, "batch_sampler", None)
        inner = getattr(batch_sampler, "batch_sampler", batch_sampler)
        if inner is not None and hasattr(inner, "set_epoch"):
            inner.set_epoch(epoch)
        if hasattr(self.base_dataloader, "set_epoch"):
            self.base_dataloader.set_epoch(epoch)

    def _stage(self, batch):
        return self._stager(batch) if self._stager is not None else batch

    def _produce_fn(self) -> Callable[[], Any]:
        """The epoch's producer: skipped batches are fetched, never staged."""
        raw_iter = iter(self.base_dataloader)
        for _ in range(self.skip_batches):
            try:
                next(raw_iter)
            except StopIteration:
                break
        return lambda: next(raw_iter)

    def _sync_staged_stream(self, produce):
        """Inline: the same lookahead, staged on the training thread, whose
        wait is then fetch + stage time."""
        def pull():
            with self.pipeline_stats.time_wait():
                raw = produce()
                with self.pipeline_stats.time_stage():
                    return self._stage(raw)

        staged: deque = deque()
        exhausted = False
        while not exhausted and len(staged) < self.prefetch_size:
            try:
                staged.append(pull())
            except StopIteration:
                exhausted = True
        while staged:
            if not exhausted:
                try:
                    staged.append(pull())
                except StopIteration:
                    exhausted = True
            yield staged.popleft()

    def _async_staged_stream(self, produce):
        prefetcher = AsyncPrefetcher(produce, self._stage, prefetch_size=self.prefetch_size,
                                     num_workers=self.num_workers, stats=self.pipeline_stats)
        try:
            while True:
                try:
                    batch = prefetcher.get()
                except StopIteration:
                    return
                yield batch
        finally:
            prefetcher.close()

    def _iterate(self, produce):
        stream = (self._async_staged_stream(produce) if self.async_prefetch
                  else self._sync_staged_stream(produce))
        try:
            current = next(stream, _END)
            while current is not _END:
                nxt = next(stream, _END)
                if nxt is _END:
                    self.end_of_dataloader = True
                    self.gradient_state._set_sync_gradients(True)
                self.batches_consumed += 1
                yield _ready(current)
                current = nxt
        finally:
            stream.close()  # joins the worker, also for an abandoned iterator
            if self.end_of_dataloader:
                self.batches_consumed = 0  # a resume starts the next epoch
            self.iteration += 1
            self.skip_batches = 0
            self.end()

    def __iter__(self):
        if self.rng_types:
            from .utils.random import synchronize_rng_states

            synchronize_rng_states(self.rng_types, self.synchronized_generator)
        self.begin()
        self.set_epoch(self.iteration)
        self.batches_consumed = self.skip_batches
        yield from self._iterate(self._produce_fn())

    def __len__(self):
        return max(0, len(self.base_dataloader) - (self.skip_batches or 0))

    def state_dict(self) -> dict:
        """Resume position: epoch and batches yielded in it."""
        return {"epoch": self.iteration, "batches_consumed": self.batches_consumed}

    def load_state_dict(self, sd: dict):
        """Restore a position from :meth:`state_dict`: the next iteration
        starts at that epoch, past the batches already yielded."""
        self.iteration = sd.get("epoch", 0)
        self.skip_batches = sd.get("batches_consumed", 0)


class DataLoaderDispatcher(DataLoaderShard):
    """The main process reads the batches and every process receives its
    slice: for a source only one process can read (a stream). The main
    process reads ``num_processes`` batches (one with ``split_batches``),
    concatenates them into the global batch and broadcasts it
    (``broadcast_object_list``); each process keeps its slice
    (``slice_fn(batch, slice, process_index, num_processes)``, default
    :func:`slice_tensors`). A last global batch that does not divide is
    completed by repeating its last sample with ``even_batches``, else
    split unevenly. In a process group the broadcast runs on the training
    thread (prefetch is inline), so every process issues it in the same
    order as the step's collectives. With a ``mesh`` the slices are the
    data shards', so the tp, cp and pp processes of one shard get the same
    rows."""

    def __init__(self, *args, split_batches: bool = False, even_batches: bool = True,
                 slice_fn: Optional[Callable] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.slice_fn = slice_fn
        self._state = PartialState()
        if self._state.process_group:
            self.async_prefetch = False

    def _shard(self) -> tuple:
        """``(index, count)`` of this process's slice of a global batch."""
        if self.mesh is not None:
            return _data_shard(self.mesh, self.device_sharding)
        return self._state.process_index, self._state.num_processes

    @property
    def total_batch_size(self):
        if self._total_batch_size is not None:
            return self._total_batch_size
        bs = getattr(self.base_dataloader, "batch_size", None) or 1
        return bs if self.split_batches else bs * self._shard()[1]

    def __len__(self):
        n = 1 if self.split_batches else self._shard()[1]
        return max(0, math.ceil(len(self.base_dataloader) / n) - (self.skip_batches or 0))

    def _fetch_and_broadcast(self, raw_iter):
        from .utils.operations import (
            broadcast_object_list,
            concatenate,
            pad_input_tensors,
            slice_tensors,
        )

        state = self._state
        index, n = self._shard()
        payload = [None, None]
        if state.is_main_process:
            fetched = []
            for _ in range(1 if self.split_batches else n):
                try:
                    fetched.append(next(raw_iter))
                except StopIteration:
                    break
            payload = [1, None] if not fetched else [
                0, fetched[0] if len(fetched) == 1 else concatenate(fetched)]
        if state.process_group:
            payload = broadcast_object_list(payload)
        if payload[0] == 1:
            raise StopIteration
        batch = payload[1]
        if n == 1:
            return batch
        size = find_batch_size(batch)
        if self.even_batches and size % n:
            batch = pad_input_tensors(batch, size, n)
            size = find_batch_size(batch)
        per, extra = divmod(size, n)
        lo = per * index + min(index, extra)
        hi = lo + per + (1 if index < extra else 0)
        return (self.slice_fn or slice_tensors)(batch, slice(lo, hi), index, n)

    def _produce_fn(self) -> Callable[[], Any]:
        raw_iter = iter(self.base_dataloader) if self._state.is_main_process else iter(())
        for _ in range(self.skip_batches):
            try:
                self._fetch_and_broadcast(raw_iter)
            except StopIteration:
                break
        return lambda: self._fetch_and_broadcast(raw_iter)


class NumpyDataLoader:
    """Map-style loader without torch's: a dataset (``len`` and
    ``__getitem__``) into numpy batches, with a seedable shuffle,
    ``drop_last`` and a ``collate_fn``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Callable = default_collate, seed: int = 0,
                 sampler=None, batch_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size if batch_sampler is None \
            else getattr(batch_sampler, "batch_size", batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.sampler = sampler if sampler is not None else (
            SeedableRandomSampler(len(dataset), seed=seed) if shuffle else range(len(dataset)))
        self.batch_sampler = batch_sampler

    def set_epoch(self, epoch: int):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _index_batches(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        yield from BatchSamplerFromSampler(self.sampler, self.batch_size, self.drop_last)

    def __iter__(self):
        for idxs in self._index_batches():
            yield self.collate_fn([self.dataset[i] for i in idxs])

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.sampler) if hasattr(self.sampler, "__len__") else len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


def prepare_data_loader(dataloader, device=None, mesh=None, device_sharding=None,
                        num_processes: Optional[int] = None,
                        process_index: Optional[int] = None, split_batches: bool = False,
                        put_on_device: bool = True, rng_types: Optional[list] = None,
                        dispatch_batches: Optional[bool] = None, even_batches: bool = True,
                        slice_fn_for_dispatch: Optional[Callable] = None,
                        use_seedable_sampler: bool = True, data_seed: Optional[int] = None,
                        non_blocking: bool = True, use_stateful_dataloader: bool = True,
                        prefetch_size: int = 2, skip_batches: int = 0,
                        async_prefetch: bool = True, num_workers: int = 1) -> DataLoaderShard:
    """Wrap a ``torch.utils.data.DataLoader``, a :class:`NumpyDataLoader` or
    any iterable of host batches into a loader that yields this process's
    batches on ``device`` (default: the state's).

    Across ``num_processes`` (default: the state's) the loader is resharded
    as in the JAX package: with ``split_batches`` each global batch (the
    loader's batch) is split, else each process reads whole batches (the
    global batch is ``batch_size * num_processes``); ``even_batches``
    completes the last round by cycling from the start. A torch loader's
    ``RandomSampler`` becomes a :class:`SeedableRandomSampler` (seed
    ``data_seed``, default 0) with ``use_seedable_sampler``, so every
    process draws one order; a torch loader over an ``IterableDataset``
    reads through :class:`IterableDatasetShard`. Any other iterable is
    taken as this process's shard already. ``dispatch_batches`` reads on
    the main process only (:class:`DataLoaderDispatcher`, which slices
    with ``slice_fn_for_dispatch``). ``use_stateful_dataloader`` is taken
    for the reference's signature: the loader keeps its resume position
    itself.

    With a ``mesh`` the shards are the mesh's data shards, not the
    processes: the rows split over the axes ``device_sharding`` splits dim
    0 over (default ``batch_sharding(mesh)``, ``dp`` x ``fsdp``), and the
    ``tp``, ``cp`` and ``pp`` processes of one shard read the same
    batches."""
    state = PartialState()
    if mesh is not None and num_processes is None and process_index is None:
        process_index, num_processes = _data_shard(mesh, device_sharding)
    num_processes = num_processes if num_processes is not None else state.num_processes
    process_index = process_index if process_index is not None else state.process_index
    device = device if device is not None else state.device
    common = dict(device=device, skip_batches=skip_batches, prefetch_size=prefetch_size,
                  async_prefetch=async_prefetch, num_workers=num_workers,
                  stage_to_device=put_on_device, non_blocking=non_blocking, rng_types=rng_types,
                  mesh=mesh, device_sharding=device_sharding)
    batch_size = getattr(dataloader, "batch_size", None) or 1
    if dispatch_batches:
        return DataLoaderDispatcher(
            dataloader, split_batches=split_batches, even_batches=even_batches,
            slice_fn=slice_fn_for_dispatch,
            total_batch_size=batch_size if split_batches else batch_size * num_processes,
            **common)
    new_loader = dataloader
    if num_processes > 1:
        if isinstance(dataloader, torch.utils.data.DataLoader):
            new_loader = _reshard_torch_dataloader(dataloader, num_processes, process_index,
                                                   split_batches, even_batches,
                                                   use_seedable_sampler, data_seed)
        elif isinstance(dataloader, NumpyDataLoader):
            shard = BatchSamplerShard(
                BatchSamplerFromSampler(dataloader.sampler, dataloader.batch_size,
                                        dataloader.drop_last),
                num_processes=num_processes, process_index=process_index,
                split_batches=split_batches, even_batches=even_batches)
            new_loader = NumpyDataLoader(dataloader.dataset, collate_fn=dataloader.collate_fn,
                                         batch_sampler=shard)
            new_loader.batch_size = (dataloader.batch_size // num_processes if split_batches
                                     else dataloader.batch_size)
    return DataLoaderShard(
        new_loader, total_batch_size=batch_size if split_batches else batch_size * num_processes,
        **common)


def _reshard_torch_dataloader(dataloader, num_processes, process_index, split_batches,
                              even_batches, use_seedable_sampler=True, data_seed=None):
    """A torch ``DataLoader`` rebuilt to read this process's shard."""
    from torch.utils.data import DataLoader, IterableDataset, RandomSampler

    kwargs = {"num_workers": dataloader.num_workers, "collate_fn": dataloader.collate_fn,
              "pin_memory": False, "timeout": dataloader.timeout,
              "worker_init_fn": dataloader.worker_init_fn}
    if isinstance(dataloader.dataset, IterableDataset):
        bs = dataloader.batch_size
        shard = IterableDatasetShard(dataloader.dataset, batch_size=bs,
                                     drop_last=dataloader.drop_last, num_processes=num_processes,
                                     process_index=process_index, split_batches=split_batches)
        return DataLoader(shard, batch_size=bs // num_processes if split_batches else bs,
                          **kwargs)
    batch_sampler = dataloader.batch_sampler
    if use_seedable_sampler and isinstance(getattr(batch_sampler, "sampler", None),
                                           RandomSampler):
        batch_sampler = BatchSamplerFromSampler(
            SeedableRandomSampler(len(dataloader.dataset), seed=data_seed or 0),
            batch_sampler.batch_size, batch_sampler.drop_last)
    shard = BatchSamplerShard(batch_sampler, num_processes=num_processes,
                              process_index=process_index, split_batches=split_batches,
                              even_batches=even_batches)
    return DataLoader(dataloader.dataset, batch_sampler=shard, **kwargs)


# ---------------------------------------------------------------------------
# Resume mid-epoch
# ---------------------------------------------------------------------------

class SkipBatchSampler:
    """An inner batch sampler's batches after the first ``skip_batches``."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)

    def __iter__(self):
        for index, samples in enumerate(self.batch_sampler):
            if index >= self.skip_batches:
                yield samples

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return len(self.batch_sampler) - self.skip_batches


class SkipDataLoader:
    """An iterable's batches after the first ``skip_batches``."""

    def __init__(self, dataloader, skip_batches: int = 0):
        self.dataloader = dataloader
        self.skip_batches = skip_batches
        self.dataset = getattr(dataloader, "dataset", None)
        self.batch_size = getattr(dataloader, "batch_size", None)

    def __iter__(self):
        for index, batch in enumerate(self.dataloader):
            if index >= self.skip_batches:
                yield batch

    def __len__(self):
        return len(self.dataloader) - self.skip_batches


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader that skips the first ``num_batches`` of its next epoch: a
    prepared loader is copied with that skip, anything else wrapped."""
    if isinstance(dataloader, DataLoaderShard):
        new = copy.copy(dataloader)
        new.skip_batches = num_batches
        return new
    return SkipDataLoader(dataloader, skip_batches=num_batches)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_sequences(sequences, seq_len: int, pad_token_id: int = 0):
    """Pack variable-length token sequences into fixed ``[N, seq_len]`` rows
    (best-fit decreasing; documents longer than ``seq_len`` are cut into
    ``seq_len`` chunks first). Returns numpy int32 arrays:

    * ``input_ids``: the documents of each row, then ``pad_token_id``;
    * ``segment_ids``: 1, 2, ... per document in its row, 0 on padding, so
      attention never crosses documents;
    * ``positions``: restarting at 0 for each document (RoPE offsets);
    * ``labels``: the next token within the document, -100 at each
      document's last token and on padding."""
    chunks = []
    for seq in sequences:
        arr = np.asarray(seq, dtype=np.int32).reshape(-1)
        for start in range(0, len(arr), seq_len):
            piece = arr[start:start + seq_len]
            if len(piece) > 0:
                chunks.append(piece)
    rows: list[list[np.ndarray]] = []
    free_sorted: list[tuple[int, int]] = []  # (free space, row), sorted
    for piece in sorted(chunks, key=len, reverse=True):
        j = bisect.bisect_left(free_sorted, (len(piece), -1))
        if j < len(free_sorted):
            free, r = free_sorted.pop(j)
            rows[r].append(piece)
            if free - len(piece) > 0:
                bisect.insort(free_sorted, (free - len(piece), r))
        else:
            rows.append([piece])
            if seq_len - len(piece) > 0:
                bisect.insort(free_sorted, (seq_len - len(piece), len(rows) - 1))

    n = len(rows)
    input_ids = np.full((n, seq_len), pad_token_id, np.int32)
    segment_ids = np.zeros((n, seq_len), np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    labels = np.full((n, seq_len), -100, np.int32)
    for r, pieces in enumerate(rows):
        offset = 0
        for s, piece in enumerate(pieces, start=1):
            length = len(piece)
            input_ids[r, offset:offset + length] = piece
            segment_ids[r, offset:offset + length] = s
            positions[r, offset:offset + length] = np.arange(length)
            labels[r, offset:offset + length - 1] = piece[1:]
            offset += length
    return {"input_ids": input_ids, "segment_ids": segment_ids, "positions": positions,
            "labels": labels}
