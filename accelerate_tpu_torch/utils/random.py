"""Seeding.

Counterpart of ``accelerate_tpu/utils/random.py`` (``set_seed``, ``:30``).
JAX threads explicit PRNG keys; torch keeps global generators (CPU and each
card) plus the generators a caller makes, so ``set_seed`` seeds python,
numpy and torch on every device. The accelerator's own stream is a
``torch.Generator`` (``Accelerator.generator``). ``synchronize_rng_states``
(``:54-84`` of the JAX file) gives every process the main process's states,
broadcast over the process group.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

import numpy as np
import torch

from .dataclasses import RNGType


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


def synchronize_rng_state(rng_type: Optional[RNGType] = None, generator=None):
    """Give every process the main process's state of one stream: torch's
    CPU generator, the current card's, numpy's, python's, or ``generator``
    (a ``torch.Generator``, a numpy ``Generator``, or an object with
    ``get_state``/``set_state``). Nothing to do without a process
    group."""
    from .operations import _group, broadcast_object_list

    if _group() is None:
        return
    rng_type = RNGType(rng_type)
    if rng_type == RNGType.TORCH:
        state = broadcast_object_list([torch.get_rng_state()])[0]
        torch.set_rng_state(state)
    elif rng_type == RNGType.CUDA:
        if torch.cuda.is_available():
            state = broadcast_object_list([torch.cuda.get_rng_state().cpu()])[0]
            torch.cuda.set_rng_state(state)
    elif rng_type == RNGType.NUMPY:
        np.random.set_state(broadcast_object_list([np.random.get_state()])[0])
    elif rng_type == RNGType.PYTHON:
        random.setstate(broadcast_object_list([random.getstate()])[0])
    elif rng_type == RNGType.GENERATOR and generator is not None:
        if isinstance(generator, np.random.Generator):
            generator.bit_generator.state = broadcast_object_list(
                [generator.bit_generator.state])[0]
        elif isinstance(generator, torch.Generator):
            generator.set_state(broadcast_object_list([generator.get_state()])[0])
        elif hasattr(generator, "get_state"):
            generator.set_state(broadcast_object_list([generator.get_state()])[0])


def synchronize_rng_states(rng_types: Iterable, generator=None):
    """:func:`synchronize_rng_state` for each of ``rng_types``."""
    for rng_type in rng_types:
        synchronize_rng_state(RNGType(rng_type), generator=generator)
