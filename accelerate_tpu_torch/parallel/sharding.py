"""Activation-checkpointing policies.

Counterpart of ``resolve_remat_policy`` in
``accelerate_tpu/parallel/sharding.py`` (``:31``). JAX names a
``jax.checkpoint`` policy; here a name says what a checkpointed decoder
layer (``models/llama.py``, ``_remat_layer``) keeps from its forward for
the backward, and so what the backward recomputes. The sharding rules of
that module are ROADMAP.md, A8c (FSDP) and A8d (meshes).
"""

from __future__ import annotations

import enum


class RematPolicy(enum.Enum):
    """What a checkpointed layer keeps for its backward."""

    # Only the layer's inputs: the backward recomputes the whole layer
    # (least activation memory; jax's nothing_saveable).
    NOTHING = "nothing"
    # Also the outputs of the products without batch dims, the projections;
    # the rest (norms, rotary, attention, activations) is recomputed
    # (jax's dots_with_no_batch_dims_saveable).
    DOTS = "dots"
    # All of it: nothing is recomputed (jax's everything_saveable; remat a
    # no-op, for debugging).
    EVERYTHING = "everything"


def resolve_remat_policy(name: str) -> RematPolicy:
    """The :class:`RematPolicy` of a remat-policy name; an unknown name
    raises ``ValueError``."""
    try:
        return RematPolicy(name)
    except ValueError:
        raise ValueError(f"unknown remat_policy {name!r}; expected "
                         f"{sorted(p.value for p in RematPolicy)}") from None
