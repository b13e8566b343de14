"""Releasing device memory and retrying a step at a smaller batch.

Counterpart of ``accelerate_tpu/utils/memory.py``: ``clear_device_cache``,
``release_memory``, ``find_executable_batch_size`` (``:58``) and
``get_device_memory_stats``. The JAX package recognises an out-of-memory
error by its message; torch raises ``torch.OutOfMemoryError``, and that is
the only error the retry catches.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable, Optional

import torch


def clear_device_cache(garbage_collection: bool = False):
    """Collect garbage (when asked) and hand the caching allocator's free
    blocks back to the card."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references in ``objects`` and clear the cache; returns a
    list of ``None`` as long as ``objects`` (``a, b = release_memory(a, b)``)."""
    objects = [None] * len(objects)
    clear_device_cache(garbage_collection=True)
    return objects


def find_executable_batch_size(function: Optional[Callable] = None,
                               starting_batch_size: int = 128,
                               reduce_batch_size_fn: Optional[Callable] = None):
    """Decorator: call ``function(batch_size, ...)`` from
    ``starting_batch_size``, halving (or ``reduce_batch_size_fn``) after each
    ``torch.OutOfMemoryError``. Any other error propagates at once."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size,
                                 reduce_batch_size_fn=reduce_batch_size_fn)
    if reduce_batch_size_fn is None:
        reduce_batch_size_fn = lambda bs: bs // 2  # noqa: E731
    batch_size = starting_batch_size

    @functools.wraps(function)
    def decorator(*args, **kwargs):
        nonlocal batch_size
        clear_device_cache(garbage_collection=True)
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < len(args) + 1:
            shown = ", ".join(f"{name}={value}" for name, value in zip(params[1:], args[1:]))
            raise TypeError(
                f"`{function.__name__}` is wrapped by find_executable_batch_size, which supplies "
                f"batch_size itself; call it without one: `{function.__name__}({shown})`")
        while True:
            if batch_size <= 0:
                raise RuntimeError("OOM retries exhausted: the batch size reached 0 and the "
                                   "step still does not fit.")
            try:
                return function(batch_size, *args, **kwargs)
            except torch.OutOfMemoryError as exc:
                reduced = reduce_batch_size_fn(batch_size)
                if reduced >= batch_size:
                    raise RuntimeError(
                        f"reduce_batch_size_fn must strictly decrease the batch size (got "
                        f"{batch_size} -> {reduced}); the OOM retry would loop forever") from exc
            # Out of the handler: the failed call's frames, which hold its
            # tensors, are gone once the exception is, so the cache can
            # hand their memory back.
            batch_size = reduced
            clear_device_cache(garbage_collection=True)

    return decorator


def get_device_memory_stats(device=None) -> dict:
    """The card's memory in use, its limit and the peak in use, in bytes
    (``torch.cuda.memory_stats`` and ``mem_get_info``)."""
    device = torch.device("cuda" if device is None else device)
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": total,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
