"""Nested batches of tensors: apply, move, gather, reduce.

Counterpart of the one-process part of ``accelerate_tpu/utils/operations.py``
(``recursively_apply`` ``:53``, ``send_to_device`` ``:79``, ``gather``
``:222``, ``gather_object`` ``:240``, ``concatenate`` ``:307``,
``pad_across_processes`` ``:317``, ``reduce`` ``:358``). On one process a
gather is the tensor itself and a reduction across processes is a local
one; the collectives over several processes come with ROADMAP.md, A8.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch


def is_tensor_like(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def honor_type(obj, generator):
    """Rebuild a sequence of ``obj``'s type, namedtuples included."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def recursively_apply(func: Callable, data, *args, test_type: Callable = is_tensor_like,
                      error_on_other_type: bool = False, **kwargs):
    """Apply ``func`` to every leaf accepted by ``test_type`` of a nested
    list/tuple/dict; other leaves pass through, or raise with
    ``error_on_other_type``."""
    if isinstance(data, (tuple, list)):
        return honor_type(data, (recursively_apply(func, o, *args, test_type=test_type,
                                                   error_on_other_type=error_on_other_type,
                                                   **kwargs) for o in data))
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type,
                                                **kwargs) for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(
            f"`{func.__name__}` cannot handle a leaf of type {type(data).__name__}: it walks "
            f"nested lists/tuples/dicts and applies only to leaves accepted by "
            f"`{test_type.__name__}`.")
    return data


def send_to_device(tensor, device, non_blocking: bool = False, skip_keys=None):
    """Every tensor of a nested batch on ``device`` (numpy arrays become
    tensors first); the keys in ``skip_keys`` stay where they are."""
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]
    if skip_keys and isinstance(tensor, Mapping):
        return type(tensor)({k: v if k in skip_keys
                             else send_to_device(v, device, non_blocking, skip_keys)
                             for k, v in tensor.items()})

    def send(t):
        t = torch.as_tensor(t)
        return t.to(device, non_blocking=non_blocking)

    return recursively_apply(send, tensor)


def gather(tensor):
    """Each process's tensors concatenated on dim 0: on one process, the
    tensors themselves."""
    return tensor


def gather_object(object: Any):
    """Each process's object in a list (lists and tuples flattened into
    one), on one process ``[object]`` or the object's own items."""
    if isinstance(object, (list, tuple)):
        return list(object)
    return [object]


def reduce(tensor, reduction: str = "sum", scale: float = 1.0):
    """Sum or mean over processes, times ``scale``: on one process the
    tensor times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    return recursively_apply(lambda t: torch.as_tensor(t) * scale, tensor)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Pad each process's tensors on ``dim`` to the longest: on one process
    they already are."""
    return tensor


def concatenate(data, dim: int = 0):
    """Leafwise concatenation of a list of like-structured batches."""
    first = data[0]
    if isinstance(first, (tuple, list)):
        return honor_type(first, (concatenate([d[i] for d in data], dim=dim)
                                  for i in range(len(first))))
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first})
    if not is_tensor_like(first):
        raise TypeError(f"Can only concatenate tensors but got {type(first)}")
    return torch.cat([torch.as_tensor(d) for d in data], dim=dim)
