"""Device choice for the port's entry points.

The JAX package runs on whatever backend JAX picked (``state.py``,
``utils/platforms.py``). The port runs on the CUDA card unless the caller
asks for the CPU by name: without a card and without that request an entry
point raises, and never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; ``"cpu"`` (or any explicit device) as asked. A
    ``torch.device`` context other than the CPU (``big_modeling``'s
    ``init_empty_weights``, ``init_on_device``) sets the default instead.

    Raises ``RuntimeError`` when no device is given and no CUDA card is
    visible, or when a CUDA device is asked for without one."""
    if device is None:
        default = torch.get_default_device()
        device = "cuda" if default.type == "cpu" else default
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
