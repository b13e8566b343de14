from .bert import BertConfig, BertForSequenceClassification, classification_loss
from .bloom import BloomConfig, BloomForCausalLM
from .gpt2 import GPT2Config, GPT2LMHeadModel
from .gpt_neox import GPTNeoXConfig, GPTNeoXForCausalLM
from .gptj import GPTJConfig, GPTJForCausalLM
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
)
from .mixtral import MixtralConfig, MixtralForCausalLM, mixtral_lm_loss
from .opt import OPTConfig, OPTForCausalLM
from .phi import PhiConfig, PhiForCausalLM
from .resnet import ResNet, ResNetConfig
from .simple import MLP, RegressionModel
from .t5 import T5Config, T5ForConditionalGeneration, seq2seq_lm_loss
from .vit import ViTConfig, ViTForImageClassification
