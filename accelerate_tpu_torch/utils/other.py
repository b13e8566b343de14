"""Small general helpers of the public surface.

Counterpart of ``accelerate_tpu/utils/other.py``: ``clear_environment``,
``get_pretty_name``, ``merge_dicts``, ``is_port_in_use``,
``convert_bytes``, ``recursive_getattr``, ``extract_model_from_parallel``
(which unwraps the port's ``AcceleratedModel``),
``clean_state_dict_for_safetensors`` (tensors sharing storage are written
once) and ``save`` (on the main process, or on each machine's).
"""

from __future__ import annotations

import os
import pickle
import socket
from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def clear_environment():
    """Empty ``os.environ`` inside the block; it comes back on exit, also
    after an error."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def get_pretty_name(obj) -> str:
    """A class's or function's name, else the object's class's, else its
    ``str``."""
    if not hasattr(obj, "__qualname__") and not hasattr(obj, "__name__"):
        obj = getattr(obj, "__class__", obj)
    if hasattr(obj, "__qualname__"):
        return obj.__qualname__
    if hasattr(obj, "__name__"):
        return obj.__name__
    return str(obj)


def merge_dicts(source: dict, destination: dict) -> dict:
    """Merge ``source`` into ``destination`` in place, nested dicts merged
    key by key; returns ``destination``."""
    for key, value in source.items():
        if isinstance(value, dict):
            merge_dicts(value, destination.setdefault(key, {}))
        else:
            destination[key] = value
    return destination


def is_port_in_use(port: int | None = None) -> bool:
    """Whether something on this host listens on ``port`` (default 29500)."""
    if port is None:
        port = 29500
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        return s.connect_ex(("localhost", int(port))) == 0


def convert_bytes(size: float) -> str:
    """``convert_bytes(1024) == "1.0 KB"``."""
    for unit in ["B", "KB", "MB", "GB", "TB", "PB"]:
        if size < 1024.0:
            return f"{round(size, 2)} {unit}"
        size /= 1024.0
    return f"{round(size, 2)} EB"


def recursive_getattr(obj, attr: str):
    """``getattr`` along a dotted path: ``recursive_getattr(m, "a.b.c")``."""
    out = obj
    for part in attr.split("."):
        out = getattr(out, part)
    return out


def extract_model_from_parallel(model, keep_fp32_wrapper: bool = True):
    """The ``nn.Module`` under a prepared model (or any wrapper keeping it
    as ``.module``); anything else as it is."""
    return getattr(model, "module", model)


def clean_state_dict_for_safetensors(state_dict: dict) -> dict:
    """A state dict safetensors can write: contiguous CPU tensors, and of
    tensors sharing one storage (tied weights) only the first name. Other
    values than tensors and arrays raise ``TypeError``."""
    seen: dict = {}
    out: dict = {}
    dropped = []
    for name, tensor in state_dict.items():
        if isinstance(tensor, np.ndarray):
            tensor = torch.from_numpy(tensor)
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"state dict entry {name!r} is {type(tensor).__name__}, not a "
                            "tensor; safetensors stores tensors only (put metadata elsewhere)")
        key = (tensor.untyped_storage().data_ptr(), tensor.storage_offset(), tuple(tensor.shape))
        if key in seen:
            dropped.append(name)
            continue
        seen[key] = name
        out[name] = tensor.detach().cpu().contiguous()
    if dropped:
        import logging

        logging.getLogger(__name__).warning(
            "Removed shared tensors %s while saving (tied entries keep their first name)",
            dropped)
    return out


def save(obj, f, save_on_each_node: bool = False, safe_serialization: bool = False):
    """Write ``obj`` on the main process only, or with
    ``save_on_each_node`` on each machine's main process.
    ``safe_serialization`` writes a flat dict of tensors as safetensors;
    anything else is pickled."""
    from ..state import PartialState

    state = PartialState()
    if not (state.is_local_main_process if save_on_each_node else state.is_main_process):
        return
    if safe_serialization:
        from safetensors.torch import save as st_save, save_file

        cleaned = clean_state_dict_for_safetensors(dict(obj))
        if hasattr(f, "write"):
            f.write(st_save(cleaned))
        else:
            save_file(cleaned, os.fspath(f))
    elif hasattr(f, "write"):
        pickle.dump(obj, f)
    else:
        with open(os.fspath(f), "wb") as fh:
            pickle.dump(obj, fh)
