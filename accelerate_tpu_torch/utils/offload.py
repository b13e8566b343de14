"""Disk offload of weights as raw memmaps plus an ``index.json``.

Counterpart of ``accelerate_tpu/utils/offload.py``, in the same on-disk
format, so either package reads a folder the other wrote: one
``<name>.dat`` per tensor (raw bytes, C order) and an index of
``{name: {"dtype": numpy name, "shape": [...]}}``. numpy has no bf16, so a
bf16 tensor is stored as its 16 bits (``"uint16"``) with
``"orig_dtype": "bfloat16"``. The streaming executor in ``big_modeling.py``
reads the files lazily, one block at a time.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

_BF16_TAG = "bfloat16"


def _to_numpy(weight):
    """(numpy array in a memmap-able dtype, the tensor's own dtype name)."""
    if isinstance(weight, torch.Tensor):
        t = weight.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.ascontiguousarray(np.asarray(weight))
    return arr, str(arr.dtype)


def offload_weight(weight, weight_name: str, offload_folder: str,
                   index: Optional[dict] = None) -> dict:
    """Write one tensor to ``{folder}/{name}.dat`` and record it in ``index``."""
    index = index if index is not None else {}
    os.makedirs(offload_folder, exist_ok=True)
    arr, orig = _to_numpy(weight)
    entry = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
    if orig == _BF16_TAG:
        entry["orig_dtype"] = _BF16_TAG
    path = os.path.join(offload_folder, f"{weight_name}.dat")
    mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=tuple(arr.shape) or (1,))
    mm[...] = arr.reshape(mm.shape)
    mm.flush()
    index[weight_name] = entry
    return index


def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """One tensor back as a CPU tensor over a copy-on-write memmap of its
    file: nothing is read until it is used, and writes never reach the
    file."""
    shape = tuple(weight_info["shape"])
    mm = np.memmap(weight_file, dtype=weight_info["dtype"], mode="c", shape=shape or (1,))
    t = torch.from_numpy(mm)
    if weight_info.get("orig_dtype") == _BF16_TAG:
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.reshape(shape)


def save_offload_index(index: dict, offload_folder: str) -> None:
    """Write ``index`` as ``{folder}/index.json``."""
    os.makedirs(offload_folder, exist_ok=True)
    with open(os.path.join(offload_folder, "index.json"), "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    """The ``index.json`` of an offload folder."""
    with open(os.path.join(offload_folder, "index.json")) as f:
        return json.load(f)


def offload_state_dict(offload_folder: str, state_dict: Mapping) -> None:
    """Offload a whole flat ``{name: tensor}`` dict, index included."""
    index: dict = {}
    for name, weight in state_dict.items():
        index = offload_weight(weight, name, offload_folder, index)
    save_offload_index(index, offload_folder)


class OffloadedWeightsLoader(Mapping):
    """A flat view over in-memory tensors and an offload folder; reading a
    key touches the disk only for offloaded ones."""

    def __init__(self, state_dict: Optional[Mapping] = None,
                 offload_folder: Optional[str] = None):
        self.state_dict = dict(state_dict or {})
        self.offload_folder = offload_folder
        self.index: dict = {}
        if offload_folder is not None and os.path.isfile(
                os.path.join(offload_folder, "index.json")):
            self.index = load_offload_index(offload_folder)
        self._keys = sorted(set(self.state_dict) | set(self.index))

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        path = os.path.join(self.offload_folder, f"{key}.dat")
        return load_offloaded_weight(path, self.index[key])

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)
