from .attention import flash_attention, flash_attention_available, softcap_logits
from .flash_cuda import flash_fwd, flash_fwd_reference
from .moe import expert_capacity, moe_mlp_apply, top_k_routing
from .quant import (
    Fp8Dense,
    fp8_matmul,
    fp8_meta_mask,
    has_fp8_meta,
    recipe_to_config_kwargs,
    wrap_optimizer_for_fp8,
)
from .ring_attention import context_parallel_attention, ring_attention, ulysses_attention
