"""Seeding.

Counterpart of ``accelerate_tpu/utils/random.py`` (``set_seed``, ``:30``).
JAX threads explicit PRNG keys; torch keeps global generators (CPU and each
card) plus the generators a caller makes, so ``set_seed`` seeds python,
numpy and torch on every device. The accelerator's own stream is a
``torch.Generator`` (``Accelerator.generator``). On one process there is no
state to synchronise across processes.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> int:
    """Seed python, numpy and torch (the CPU generator and every CUDA
    card's). ``device_specific`` adds the process index (0 on one process);
    ``deterministic`` asks torch for deterministic algorithms. Returns the
    seed used."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)  # also seeds every CUDA card
    if deterministic:
        torch.use_deterministic_algorithms(True)
    return seed
