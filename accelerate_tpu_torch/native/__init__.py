"""ctypes bindings for the native host-IO runtime (``atpu_native.cpp``).

Counterpart of ``accelerate_tpu/native/__init__.py``, over the port's own
copy of the C++ source: parallel region reads for checkpoint shards
(:func:`parallel_read`) and a batch prefetch ring for the data pipeline
(:class:`PrefetchRing`). Host code, no card involved. Everything degrades
to a pure-Python path when no compiler is available (:func:`available`
probes once).

Build model: compiled on first use with g++ into
``accelerate_tpu_torch/_build/native/`` (git-ignored), one ``.so`` per
source hash, stamped with that hash and checked before it is loaded; a
build writes a temporary file and renames it, so concurrent builds race
harmlessly (~1 s); no pip or cmake.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "atpu_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "native")
_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _is_stamped(so_path: str, tag: str) -> bool:
    """True if the binary embeds the current source hash. Checked on the raw
    bytes (no dlopen) so a stale/tampered cache is never executed."""
    try:
        with open(so_path, "rb") as f:
            return f"ATPU_HASH:{tag}".encode() in f.read()
    except OSError:
        return False


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = _source_tag()
    so_path = os.path.join(_BUILD_DIR, f"libatpu_native_{tag}.so")
    if os.path.exists(so_path) and _is_stamped(so_path, tag):
        return so_path
    tmp = so_path + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        f'-DATPU_SOURCE_HASH="{tag}"', _SRC, "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, so_path)  # atomic: concurrent builds race harmlessly
    return so_path


def _load():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
            lib.atpu_par_read.restype = ctypes.c_int
            lib.atpu_par_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int64,
                ctypes.c_int,
            ]
            lib.atpu_ring_create.restype = ctypes.c_void_p
            lib.atpu_ring_create.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.atpu_ring_num_batches.restype = ctypes.c_int64
            lib.atpu_ring_num_batches.argtypes = [ctypes.c_void_p]
            lib.atpu_ring_next.restype = ctypes.c_int64
            lib.atpu_ring_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.atpu_ring_destroy.restype = None
            lib.atpu_ring_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception as e:  # no compiler / unwritable dir / load failure
            _lib_error = str(e)
            logger.warning("native runtime unavailable (%s); using Python fallback", e)
    return _lib


def available() -> bool:
    return _load() is not None


def parallel_read(path: str, offsets, sizes, dests: Sequence[np.ndarray], threads: int = 8):
    """Read ``len(offsets)`` byte regions of ``path`` into the given numpy
    buffers concurrently. Falls back to sequential reads without the lib."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    if len(dests) != offsets.size or sizes.size != offsets.size:
        raise ValueError("offsets, sizes and dests must have equal length")
    for d, s in zip(dests, sizes):
        if not (isinstance(d, np.ndarray) and d.flags["C_CONTIGUOUS"]):
            raise ValueError("dests must be C-contiguous numpy arrays")
        if d.nbytes < s:
            raise ValueError(f"dest buffer {d.nbytes}B smaller than region {s}B")
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            for off, size, dest in zip(offsets, sizes, dests):
                f.seek(int(off))
                buf = f.read(int(size))
                if len(buf) != int(size):
                    # Same contract as the native path: a truncated region is
                    # an IO error, never silently-garbage weights.
                    raise IOError(
                        f"{path}: short read at offset {int(off)} "
                        f"({len(buf)} of {int(size)} bytes)"
                    )
                dest.view(np.uint8).reshape(-1)[: len(buf)] = np.frombuffer(buf, np.uint8)
        return
    ptrs = (ctypes.c_void_p * len(dests))(
        *[d.ctypes.data_as(ctypes.c_void_p) for d in dests]
    )
    rc = lib.atpu_par_read(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ptrs,
        len(dests),
        threads,
    )
    if rc != 0:
        raise IOError(f"atpu_par_read failed on {path}")


class PrefetchRing:
    """Ordered batch prefetcher over sample regions of one file.

    Python owns the schedule (``sample_offsets`` — shuffled/sharded/skipped
    upstream); the native producer assembles batches ``depth`` ahead with a
    reader pool. Iterating yields ``(buffer, valid_samples)`` where buffer is
    a ``[batch_size * sample_bytes]`` uint8 array (caller reshapes/casts).
    """

    def __init__(
        self,
        path: str,
        sample_offsets,
        sample_bytes: int,
        batch_size: int,
        depth: int = 4,
        threads: int = 4,
    ):
        self.path = path
        self.sample_offsets = np.ascontiguousarray(sample_offsets, np.int64)
        self.sample_bytes = int(sample_bytes)
        self.batch_size = int(batch_size)
        self.depth = int(depth)
        self.threads = int(threads)
        self._handle = None
        self._lib = _load()

    @property
    def num_batches(self) -> int:
        n = len(self.sample_offsets)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self._lib is None:
            yield from self._python_iter()
            return
        handle = self._lib.atpu_ring_create(
            self.path.encode(),
            self.sample_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self.sample_offsets),
            self.sample_bytes,
            self.batch_size,
            self.depth,
            self.threads,
        )
        if not handle:
            raise IOError(f"atpu_ring_create failed on {self.path}")
        try:
            while True:
                out = np.empty(self.batch_size * self.sample_bytes, np.uint8)
                valid = self._lib.atpu_ring_next(handle, out.ctypes.data_as(ctypes.c_void_p))
                if valid < 0:
                    raise IOError(f"prefetch ring IO error on {self.path}")
                if valid == 0:
                    return
                yield out, int(valid)
        finally:
            self._lib.atpu_ring_destroy(handle)

    def _python_iter(self):
        with open(self.path, "rb") as f:
            n = len(self.sample_offsets)
            for start in range(0, n, self.batch_size):
                idx = self.sample_offsets[start : start + self.batch_size]
                out = np.empty(self.batch_size * self.sample_bytes, np.uint8)
                for i, off in enumerate(idx):
                    f.seek(int(off))
                    buf = f.read(self.sample_bytes)
                    if len(buf) != self.sample_bytes:
                        raise IOError(
                            f"{self.path}: short read at offset {int(off)} "
                            f"({len(buf)} of {self.sample_bytes} bytes)"
                        )
                    out[i * self.sample_bytes : (i + 1) * self.sample_bytes] = np.frombuffer(
                        buf, np.uint8
                    )
                yield out, len(idx)
