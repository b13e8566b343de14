"""Data loading: index samplers, loaders, resume, packing, and batches on
the device.

Counterpart of ``accelerate_tpu/data_loader.py`` for one process on one
device: ``SeedableRandomSampler`` (``:51``), ``BatchSamplerShard`` (``:79``),
``default_collate`` (``:275``), ``make_global_batch`` (``:296``),
``AsyncPrefetcher`` (``:373``), ``DataLoaderStateMixin`` (``:516``),
``DataLoaderShard`` (``:550``), ``NumpyDataLoader`` (``:881``),
``prepare_data_loader`` (``:979``), ``SkipBatchSampler`` /
``SkipDataLoader`` / ``skip_first_batches`` (``:1099-1150``) and
``pack_sequences`` (``:1152``).

What differs from the JAX package: there is no mesh, so the global batch is
the host batch, placed on the accelerator's device. On ``cuda`` a batch is
staged through pinned host memory with a ``non_blocking`` copy on a side
stream; the training stream waits on the copy's event and records the
tensors' use (``record_stream``) before it reads them, so the caching
allocator never hands the buffers out while they are in use. The
dispatcher, ``IterableDatasetShard`` and even batches across processes come
with several processes (ROADMAP.md, A8).
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
from .utils.operations import recursively_apply
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


def make_global_batch(local_batch, device=None):
    """A dict (or list/tuple) of numpy arrays or tensors, nested or not, as
    tensors on ``device``: an ``Accelerator`` (its device), a device, or
    None (``cuda``, which raises without a card). Integer leaves become
    int64, floating ones float32, booleans stay bool."""
    device = _device_of(device)
    return recursively_apply(lambda x: _host_tensor(x).to(device), local_batch,
                             test_type=_any_leaf)


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
      batches yielded in it)."""

    def __init__(self, base_dataloader: Iterable, device=None, skip_batches: int = 0,
                 prefetch_size: int = 2, total_batch_size: Optional[int] = None,
                 dataset_length: Optional[int] = None, stage_to_device: bool = True,
                 async_prefetch: bool = True, num_workers: int = 1, non_blocking: bool = True):
        self.base_dataloader = base_dataloader
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
        return (bs or 1) * PartialState().num_processes

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


def prepare_data_loader(dataloader, device=None, put_on_device: bool = True,
                        dispatch_batches: Optional[bool] = None, non_blocking: bool = True,
                        prefetch_size: int = 2, skip_batches: int = 0,
                        async_prefetch: bool = True, num_workers: int = 1) -> DataLoaderShard:
    """Wrap a ``torch.utils.data.DataLoader``, a :class:`NumpyDataLoader` or
    any iterable of host batches into a :class:`DataLoaderShard` that yields
    batches on ``device`` (default: the state's). On one process nothing is
    resharded: the loader's batch is the global batch."""
    state = PartialState()
    if state.num_processes > 1 or dispatch_batches:
        raise NotImplementedError("sharding or dispatching a loader across processes is not "
                                  "ported to accelerate_tpu_torch yet (ROADMAP.md, A8)")
    return DataLoaderShard(
        dataloader, device=device if device is not None else state.device,
        skip_batches=skip_batches, prefetch_size=prefetch_size, async_prefetch=async_prefetch,
        num_workers=num_workers, stage_to_device=put_on_device, non_blocking=non_blocking,
        total_batch_size=getattr(dataloader, "batch_size", None) or 1)


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
