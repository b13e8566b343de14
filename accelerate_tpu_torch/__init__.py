"""PyTorch/CUDA port of accelerate_tpu for NVIDIA Hopper (H100).

A self-contained package beside ``accelerate_tpu`` (the JAX reference,
which it never imports). It holds the Llama forward and KV-cached
``generate``, and training: ``Accelerator.prepare`` and the fused
``compile_train_step`` over the chunked LM-head loss, with attention on
hand-written Hopper flash-attention kernels, forward and backward. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .accelerator import AcceleratedModel, Accelerator
from .data_loader import make_global_batch
from .generation import generate, greedy_generate
from .models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
    fused_causal_lm_loss,
    init_kv_cache,
    init_weights,
)
from .ops.attention import flash_attention, flash_attention_available
from .ops.flash_cuda import (
    FlashAttentionFunction,
    flash_bwd,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
)
from .ops.fused_loss import chunked_softmax_xent
from .optimizer import AcceleratedOptimizer
from .precision import GradScalerKwargs, Policy, policy_for
from .utils.convert import flax_from_state_dict, state_dict_from_flax
from .utils.device import resolve_device
