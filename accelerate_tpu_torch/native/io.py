"""High-throughput host IO on the native runtime.

Counterpart of ``accelerate_tpu/native/io.py``:

* :func:`fast_load_safetensors`: parse the safetensors header in Python,
  then pull every tensor's byte region in parallel through
  :func:`~accelerate_tpu_torch.native.parallel_read`, into CPU tensors (bf16
  arrives as ``torch.bfloat16``). ``checkpointing.load_safetensors_model``
  reads through it.
* :class:`TokenBinDataLoader`: an iterable over a flat binary token file
  (one contiguous int array, the usual pretraining format), yielding
  ``{"input_ids": [batch, seq]}`` CPU tensors assembled by the native
  prefetch ring. The schedule (shuffle, process shard, resume skip) is
  computed here in numpy and handed to the ring as explicit offsets.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from . import PrefetchRing, parallel_read

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _st_dtype(name: str) -> torch.dtype:
    if name not in _ST_DTYPES:
        raise ValueError(f"unsupported safetensors dtype {name}")
    return _ST_DTYPES[name]


def read_safetensors_header(path: str):
    """Return (header dict, data_start offset)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    header.pop("__metadata__", None)
    return header, 8 + hlen


def fast_load_safetensors(path: str, threads: int = 8) -> dict:
    """Every tensor of a safetensors file, read with parallel region reads:
    a flat ``{name: CPU tensor}`` dict (the file's names)."""
    header, base = read_safetensors_header(path)
    offsets, sizes, dests, out = [], [], [], {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        dtype = _st_dtype(info["dtype"])
        buf = torch.empty(end - start, dtype=torch.uint8)
        offsets.append(base + start)
        sizes.append(end - start)
        dests.append(buf.numpy())
        out[name] = (buf, dtype, info["shape"])
    parallel_read(path, offsets, sizes, dests, threads=threads)
    return {name: buf.view(dtype).reshape(shape) for name, (buf, dtype, shape) in out.items()}


class TokenBinDataLoader:
    """Sharded, shuffled, resumable loader over a flat token binary.

    File layout: one contiguous array of ``token_dtype`` tokens; sample
    ``i`` is the ``seq_len``-token window starting at token ``i * stride``
    (``stride = seq_len`` for non-overlapping pretraining windows). Each
    process reads its slice of the (shuffled) schedule; the native ring
    keeps ``prefetch_depth`` batches in flight. ``set_epoch`` reshuffles;
    ``state_dict``/``load_state_dict`` resume after the batches seen.
    """

    def __init__(
        self,
        path: str,
        seq_len: int,
        batch_size: int,
        *,
        token_dtype=np.int32,
        stride: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        num_processes: int = 1,
        process_index: int = 0,
        drop_last: bool = True,
        prefetch_depth: int = 4,
        threads: int = 4,
    ):
        self.path = path
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.token_dtype = np.dtype(token_dtype)
        self.stride = int(stride or seq_len)
        self.shuffle = shuffle
        self.seed = seed
        self.num_processes = num_processes
        self.process_index = process_index
        self.drop_last = drop_last
        self.prefetch_depth = prefetch_depth
        self.threads = threads
        self.epoch = 0
        self._skip_batches = 0
        self._batches_seen = 0

        total_tokens = os.path.getsize(path) // self.token_dtype.itemsize
        self.num_samples_total = max((total_tokens - self.seq_len) // self.stride + 1, 0)
        if self.num_samples_total <= 0:
            raise ValueError(f"{path}: too few tokens ({total_tokens}) for seq_len {seq_len}")

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "skip_batches": self._batches_seen}

    def load_state_dict(self, state: dict):
        self.epoch = int(state.get("epoch", 0))
        self._skip_batches = int(state.get("skip_batches", 0))
        # Restored progress counts as seen, so a save before iterating
        # round-trips.
        self._batches_seen = self._skip_batches

    def _schedule(self) -> np.ndarray:
        """This process's sample byte offsets for the current epoch."""
        order = np.arange(self.num_samples_total, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        per = self.num_samples_total // self.num_processes
        if self.drop_last or self.num_processes > 1:
            order = order[: per * self.num_processes]
        order = order[self.process_index::self.num_processes]
        if self._skip_batches:
            order = order[self._skip_batches * self.batch_size:]
        return order * (self.stride * self.token_dtype.itemsize)

    def __len__(self):
        n = len(self._schedule())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        schedule = self._schedule()
        sample_bytes = self.seq_len * self.token_dtype.itemsize
        ring = PrefetchRing(self.path, schedule, sample_bytes, self.batch_size,
                            depth=self.prefetch_depth, threads=self.threads)
        self._batches_seen = self._skip_batches
        self._skip_batches = 0
        for buf, valid in ring:
            if valid < self.batch_size and self.drop_last:
                break
            batch = buf.view(self.token_dtype).reshape(self.batch_size, self.seq_len)
            self._batches_seen += 1
            yield {"input_ids": torch.from_numpy(batch[:valid])}
