"""Cache registry of the port: which models thread a KV cache.

Counterpart of ``accelerate_tpu/big_modeling.py::cache_factory_for`` (its
Llama branch); the other families are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def cache_factory_for(module) -> Optional[Callable]:
    """``(batch, max_len, dtype=bf16, ring_slack=0) -> per-layer KV cache``
    on the module's device, for model families with cache threading; None
    otherwise."""
    from .models.llama import LlamaForCausalLM, init_kv_cache

    if not isinstance(module, LlamaForCausalLM):
        return None
    cfg = module.config
    device = next(module.parameters()).device

    def factory(batch, max_len, dtype=torch.bfloat16, ring_slack=0):
        return init_kv_cache(cfg, batch, max_len, dtype, ring_slack=ring_slack, device=device)

    return factory
