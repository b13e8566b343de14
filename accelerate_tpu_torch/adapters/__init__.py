"""Multi-tenant LoRA adapters: train, hot-load and serve many adapters over
one base model.

Counterpart of ``accelerate_tpu/adapters``: the core (``lora.py``), the
serving bank (``registry.py``, :class:`AdapterBank`) and the int8 base
weights under it (``quantize.py``). Adapter checkpoints are
``checkpointing.save_adapter`` / ``load_adapter``, re-exported here.
"""

from ..checkpointing import load_adapter, save_adapter
from .lora import (
    DEFAULT_TARGET_MODULES,
    LoRAConfig,
    LoRATrainState,
    adapter_module_paths,
    adapter_rank,
    adapter_spec,
    count_lora_params,
    init_lora_params,
    lora_delta,
    merge_adapter,
    pad_adapter,
    prepare_lora,
    target_paths,
)
from .quantize import QuantizedLinear, dequantized_state_dict, quantize_base_weights
from .registry import AdapterBank, AdapterBankFull, UnknownAdapterError

__all__ = [
    "DEFAULT_TARGET_MODULES",
    "AdapterBank",
    "AdapterBankFull",
    "LoRAConfig",
    "LoRATrainState",
    "QuantizedLinear",
    "UnknownAdapterError",
    "adapter_module_paths",
    "adapter_rank",
    "adapter_spec",
    "count_lora_params",
    "dequantized_state_dict",
    "init_lora_params",
    "load_adapter",
    "lora_delta",
    "merge_adapter",
    "pad_adapter",
    "prepare_lora",
    "quantize_base_weights",
    "save_adapter",
    "target_paths",
]
