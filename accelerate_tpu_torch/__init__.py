"""PyTorch/CUDA port of accelerate_tpu for NVIDIA Hopper (H100).

A self-contained package beside ``accelerate_tpu`` (the JAX reference,
which it never imports). This slice: the Llama forward on a hand-written
Hopper flash-attention kernel, and KV-cached ``generate``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .generation import generate, greedy_generate
from .models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
    init_kv_cache,
    init_weights,
)
from .ops.attention import flash_attention, flash_attention_available
from .ops.flash_cuda import flash_fwd, flash_fwd_reference
from .precision import Policy, policy_for
from .utils.convert import flax_from_state_dict, state_dict_from_flax
from .utils.device import resolve_device
