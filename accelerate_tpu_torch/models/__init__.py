from .llama import LlamaConfig, LlamaForCausalLM, PipelinedLlamaForCausalLM
