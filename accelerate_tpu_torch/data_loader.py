"""Host batches onto the device.

Counterpart of ``make_global_batch`` in ``accelerate_tpu/data_loader.py``,
for one device: there is no mesh to shard over, so the global batch is the
host batch, placed on the accelerator's device. The rest of the JAX data
loader (sharded samplers, the dispatcher, async prefetch, sequence packing)
is not ported yet (ROADMAP.md, A3).
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def make_global_batch(local_batch, device=None):
    """A dict (or list/tuple) of numpy arrays, nested or not, as tensors on
    ``device``: an ``Accelerator`` (its device), a device, or None
    (``cuda``, which raises without a card). Integer arrays become int64
    (token ids index an embedding), floating ones float32, booleans stay
    bool."""
    if not isinstance(device, (str, torch.device)) and hasattr(device, "device"):
        device = device.device
    device = resolve_device(device)

    def make(x):
        if isinstance(x, dict):
            return {k: make(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(make(v) for v in x)
        array = np.asarray(x)
        if array.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(array.dtype, np.integer):
            dtype = torch.int64
        elif np.issubdtype(array.dtype, np.floating):
            dtype = torch.float32
        else:
            raise TypeError(f"make_global_batch takes numeric arrays, got {array.dtype}")
        return torch.from_numpy(np.ascontiguousarray(array)).to(device=device, dtype=dtype)

    return make(local_batch)
