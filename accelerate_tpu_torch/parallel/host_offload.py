"""Host-memory offload of training state (ZeRO-offload).

Counterpart of ``accelerate_tpu/parallel/host_offload.py``. The JAX
package moves each optimizer-state leaf into the ``pinned_host`` memory
space between steps, keeping its sharding. Here the leaves are tensors in
dicts (the optimizer's per-parameter state): ``to_host`` copies each one
into page-locked host memory when the tensors live on the card, and
``to_device`` copies it back onto the accelerator's device; an
:class:`~accelerate_tpu_torch.optimizer.AcceleratedOptimizer` with
``offload_to_host`` streams its state in for the update and out after it,
so the forward and backward run with no optimizer state on the card.

On a CPU accelerator there is nothing to pin (page-locked memory is a CUDA
allocation): the state goes to plain host tensors, which report the memory
kind ``unpinned_host``, so the CPU tests run the same code. On the card a
failure to pin raises; the state never stays on the card quietly.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

HOST_MEMORY_KIND = "pinned_host"
UNPINNED_HOST_MEMORY_KIND = "unpinned_host"
DEVICE_MEMORY_KIND = "device"

# Host copies made by ``to_host`` that could not be pinned (a CPU
# accelerator), by id: they report UNPINNED_HOST_MEMORY_KIND.
_unpinned = weakref.WeakValueDictionary()


def supports_host_memory(device=None) -> bool:
    """True when state can be offloaded off ``device``'s memory: always on
    the CPU (into plain host tensors), on the card when it can pin."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type == "cpu":
        return True
    try:
        return torch.empty(1).pin_memory().is_pinned()
    except RuntimeError:
        return False


def memory_kind_of(leaf) -> Optional[str]:
    """Where a tensor lives: ``device`` (the accelerator's memory),
    ``pinned_host`` or ``unpinned_host`` (a ``to_host`` copy on a CPU
    accelerator); None for anything but a tensor."""
    if not isinstance(leaf, torch.Tensor):
        return None
    if leaf.device.type != "cpu":
        return DEVICE_MEMORY_KIND
    if leaf.is_pinned():
        return HOST_MEMORY_KIND
    if _unpinned.get(id(leaf)) is leaf:
        return UNPINNED_HOST_MEMORY_KIND
    return DEVICE_MEMORY_KIND


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu":
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if not out.is_pinned():
            raise RuntimeError("host offload: the host copy could not be pinned")
        out.copy_(t, non_blocking=True)
        return out
    out = t.clone()
    _unpinned[id(out)] = out
    return out


def put_tree(tree, kind: str, device=None):
    """Every tensor of ``tree`` (nested dicts, lists, tuples) moved to the
    memory ``kind``: ``pinned_host`` (a host copy; pinned unless the
    tensor is already on the CPU) or ``device`` (onto ``device``, default
    the accelerator's). Tensors already there, and anything else, pass
    through. A copy to the host is complete when this returns."""
    if kind == HOST_MEMORY_KIND:
        moved = _map(lambda t: _host_copy(t) if memory_kind_of(t) == DEVICE_MEMORY_KIND
                     else t, tree)
        if any(isinstance(t, torch.Tensor) and t.is_pinned() for t in _leaves(moved)):
            torch.cuda.current_stream().synchronize()
        return moved
    if kind == DEVICE_MEMORY_KIND:
        if device is None:
            from ..state import PartialState

            device = PartialState().device
        device = torch.device(device)

        def back(t):
            kind_of = memory_kind_of(t)
            if kind_of not in (HOST_MEMORY_KIND, UNPINNED_HOST_MEMORY_KIND):
                return t
            return t.to(device, non_blocking=True) if device.type != "cpu" else t.clone()

        return _map(back, tree)
    raise ValueError(f"unknown memory kind {kind!r}; expected {HOST_MEMORY_KIND!r} or "
                     f"{DEVICE_MEMORY_KIND!r}")


def to_host(tree, device=None):
    """Stream every tensor of ``tree`` to host memory (pinned off the card)."""
    return put_tree(tree, HOST_MEMORY_KIND, device)


def to_device(tree, device=None):
    """Stream every tensor of ``tree`` back onto ``device`` (default the
    accelerator's)."""
    return put_tree(tree, DEVICE_MEMORY_KIND, device)


def tree_memory_kinds(tree) -> set:
    """The memory kinds the tensors of ``tree`` occupy."""
    return {memory_kind_of(t) for t in _leaves(tree) if isinstance(t, torch.Tensor)}
