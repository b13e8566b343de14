"""Nested batches of tensors: apply, move, inspect, and the collectives.

Counterpart of ``accelerate_tpu/utils/operations.py``: the nested-batch
walk (``recursively_apply`` ``:53``, ``send_to_device`` ``:79``), the
one-process helpers (``get_data_structure``, ``get_shape``,
``initialize_tensors``, ``find_batch_size``, ``listify``,
``slice_tensors``, ``pad_input_tensors``, ``convert_to_fp32``,
``convert_outputs_to_fp32`` ``:389-415``, ``find_device``), and the
collectives over the process group (``gather`` ``:220``, ``gather_object``
``:239``, ``broadcast`` ``:270``, ``broadcast_object_list`` ``:290``,
``pad_across_processes`` ``:327``, ``reduce`` ``:366``), on
``torch.distributed``: NCCL moves tensors on the card, gloo on the CPU.
Without a process group each collective is the identity (``reduce``
scales); the collectives over a mesh's groups are
``parallel/mesh.py``'s ``AxisGroup``. Under ``debug`` (``ACCELERATE_TPU_DEBUG``) a tensor collective
first compares every rank's shapes and raises
``DistributedOperationException`` naming the op and each rank's shape
(``verify_operation`` ``:139-182``). A tensor comes back on the device it
came from; a numpy array comes back as a CPU tensor.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch


class DistributedOperationException(Exception):
    """A collective was called with shapes that differ across processes."""


@dataclass(frozen=True)
class TensorInformation:
    """Shape and dtype of a tensor, without its data."""

    shape: torch.Size
    dtype: torch.dtype


def _group() -> Optional[dict]:
    """The process state when it holds a process group, else None (the
    state is read, never built: one process needs none)."""
    from ..state import PartialState
    from .dataclasses import DistributedType

    state = PartialState._shared_state
    if state and state.get("distributed_type", DistributedType.NO) != DistributedType.NO:
        return state
    return None


def _to_comm(t, state) -> tuple:
    """``t`` as a contiguous tensor where the backend moves it (the card
    for NCCL, the CPU for gloo), and the device to return it to."""
    t = torch.as_tensor(t)
    home = t.device
    where = state["device"] if state["backend"] == "nccl" else torch.device("cpu")
    return t.to(where).contiguous(), home


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


def get_data_structure(data):
    """The nested batch with every tensor replaced by its
    :class:`TensorInformation`."""
    return recursively_apply(
        lambda t: TensorInformation(torch.Size(np.shape(t)), torch.as_tensor(t).dtype), data)


def get_shape(data):
    """The nested batch with every tensor replaced by its shape, a list."""
    return recursively_apply(lambda t: list(np.shape(t)), data)


def initialize_tensors(data_structure):
    """Zero tensors of the shapes and dtypes of a
    :func:`get_data_structure` result."""
    return recursively_apply(lambda s: torch.zeros(s.shape, dtype=s.dtype), data_structure,
                             test_type=lambda x: isinstance(x, TensorInformation))


def _leaves(data):
    """Leaves in the JAX package's order: dict keys sorted, None skipped."""
    if isinstance(data, (list, tuple)):
        for item in data:
            yield from _leaves(item)
    elif isinstance(data, Mapping):
        for key in sorted(data):
            yield from _leaves(data[key])
    elif data is not None:
        yield data


def find_batch_size(data) -> Optional[int]:
    """The leading dim of the first leaf with one (None without)."""
    for leaf in _leaves(data):
        if hasattr(leaf, "shape") and len(leaf.shape) > 0:
            return int(leaf.shape[0])
    return None


def ignorant_find_batch_size(data) -> Optional[int]:
    """:func:`find_batch_size`, None where it raises."""
    try:
        return find_batch_size(data)
    except (TypeError, IndexError):
        return None


def listify(data):
    """The nested batch with every tensor as nested Python lists."""
    return recursively_apply(lambda t: torch.as_tensor(t).tolist(), data)


def find_device(data) -> Optional[torch.device]:
    """The device of the first tensor leaf."""
    for leaf in _leaves(data):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def slice_tensors(data, tensor_slice, process_index=None, num_processes=None):
    """Every tensor of the nested batch indexed by ``tensor_slice``."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Tensors whose ``dim`` is ``batch_size`` grown to the next multiple
    of ``num_processes`` by repeating their last entry along ``dim``."""
    remainder = batch_size % num_processes
    if remainder == 0:
        return tensor
    to_add = num_processes - remainder

    def pad(t):
        t = torch.as_tensor(t)
        if dim >= t.ndim or t.shape[dim] != batch_size:
            return t
        last = t.narrow(dim, t.shape[dim] - 1, 1)
        return torch.cat([t] + [last] * to_add, dim=dim)

    return recursively_apply(pad, tensor)


def convert_to_fp32(tensor):
    """fp16 and bf16 tensors of the nested batch upcast to f32."""
    def is_half(t):
        return isinstance(t, torch.Tensor) and t.dtype in (torch.float16, torch.bfloat16)

    return recursively_apply(lambda t: t.float(), tensor, test_type=is_half)


class ConvertOutputsToFp32:
    """A forward whose fp16/bf16 outputs come back as f32."""

    def __init__(self, model_forward):
        self.model_forward = model_forward
        functools.update_wrapper(self, model_forward)

    def __call__(self, *args, **kwargs):
        return convert_to_fp32(self.model_forward(*args, **kwargs))


def convert_outputs_to_fp32(model_forward):
    return ConvertOutputsToFp32(model_forward)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _verify_shapes_across_processes(tensor, op_name: str):
    """Raise when the ranks' shapes differ, with each rank's shapes."""
    import torch.distributed as dist

    shapes = [None] * dist.get_world_size()
    dist.all_gather_object(shapes, get_shape(tensor))
    if any(s != shapes[0] for s in shapes):
        table = "\n".join(f"  - Process {i}: {s}" for i, s in enumerate(shapes))
        raise DistributedOperationException(
            f"Cannot apply the `{op_name}` operation: tensor shapes differ across "
            f"processes:\n{table}")


def verify_operation(function: Callable):
    """Decorator: under ``debug``, compare every rank's shapes before the
    collective."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        state = _group()
        if state is not None and state.get("debug", False):
            tensor = kwargs.get("tensor", args[0] if args else None)
            if tensor is not None:
                _verify_shapes_across_processes(tensor, function.__name__)
        return function(*args, **kwargs)

    return wrapper


def _all_gather_cat(t, state):
    import torch.distributed as dist

    x, home = _to_comm(t, state)
    is_bool = x.dtype == torch.bool
    x = x.to(torch.uint8) if is_bool else x
    x = x.reshape(1) if x.ndim == 0 else x
    parts = [torch.empty_like(x) for _ in range(state["num_processes"])]
    dist.all_gather(parts, x)
    out = torch.cat(parts)
    return (out.bool() if is_bool else out).to(home)


@verify_operation
def gather(tensor):
    """Every process's tensors concatenated on dim 0, in rank order (a
    scalar counts as one row); without a process group, the tensors."""
    state = _group()
    if state is None:
        return tensor
    return recursively_apply(lambda t: _all_gather_cat(t, state), tensor)


def gather_object(object: Any):
    """Every process's picklable object, in rank order; when each is a
    list or tuple, one list of their items. Without a process group,
    ``[object]`` (or the object's items)."""
    state = _group()
    if state is None:
        objects = [object]
    else:
        import torch.distributed as dist

        objects = [None] * state["num_processes"]
        dist.all_gather_object(objects, object)
    if all(isinstance(o, (list, tuple)) for o in objects):
        return [x for o in objects for x in o]
    return objects


@verify_operation
def broadcast(tensor, from_process: int = 0):
    """Process ``from_process``'s tensors on every process."""
    state = _group()
    if state is None:
        return tensor
    import torch.distributed as dist

    def one(t):
        x, home = _to_comm(t, state)
        x = x.clone()
        dist.broadcast(x, src=from_process)
        return x.to(home)

    return recursively_apply(one, tensor)


def broadcast_object_list(object_list: list, from_process: int = 0):
    """Process ``from_process``'s picklable objects written into
    ``object_list`` on every process, in place; returns it."""
    state = _group()
    if state is not None:
        import torch.distributed as dist

        dist.broadcast_object_list(object_list, src=from_process)
    return object_list


@verify_operation
def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Each tensor padded with ``pad_index`` on ``dim`` to the longest any
    process holds (at the front with ``pad_first``), so it can be
    gathered; without a process group, the tensors."""
    state = _group()
    if state is None:
        return tensor

    def pad(t):
        t = torch.as_tensor(t)
        if dim >= t.ndim:
            return t
        size = int(_all_gather_cat(torch.tensor([t.shape[dim]]), state).max())
        if size == t.shape[dim]:
            return t
        shape = list(t.shape)
        shape[dim] = size - t.shape[dim]
        filler = torch.full(shape, pad_index, dtype=t.dtype, device=t.device)
        return torch.cat([filler, t] if pad_first else [t, filler], dim=dim)

    return recursively_apply(pad, tensor)


@verify_operation
def reduce(tensor, reduction: str = "sum", scale: float = 1.0):
    """The sum, or mean, of every process's tensors, times ``scale``;
    without a process group, the tensors times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    state = _group()

    def one(t):
        if state is None:
            return torch.as_tensor(t) * scale
        import torch.distributed as dist

        x, home = _to_comm(t, state)
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        if reduction == "mean":
            x = x / state["num_processes"]
        return (x * scale).to(home)

    return recursively_apply(one, tensor)
