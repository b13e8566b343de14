from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
)
from .mixtral import MixtralConfig, MixtralForCausalLM, mixtral_lm_loss
