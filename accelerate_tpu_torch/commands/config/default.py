"""``accelerate-tpu-torch config default``: write a configuration without
questions (counterpart of ``accelerate_tpu/commands/config/default.py``)."""

from __future__ import annotations

from .config_args import ClusterConfig


def write_basic_config(mixed_precision: str = "bf16", config_file=None):
    """One machine, bf16 (the card's fast matmul type); returns the path."""
    return ClusterConfig(mixed_precision=mixed_precision).save(config_file)
