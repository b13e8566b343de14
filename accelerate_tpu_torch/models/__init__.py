from .llama import LlamaConfig, LlamaForCausalLM, PipelinedLlamaForCausalLM
from .mixtral import MixtralConfig, MixtralForCausalLM, mixtral_lm_loss
