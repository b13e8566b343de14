"""PyTorch/CUDA port of accelerate_tpu for NVIDIA Hopper (H100).

A self-contained package beside ``accelerate_tpu`` (the JAX reference,
which it never imports). It holds the Llama forward, KV-cached
``generate``, the speculative decoders (``prompt_lookup_generate``,
``assisted_generate``) and ``beam_search_generate``, and training: ``Accelerator.prepare`` of models, optimizers,
schedulers and data loaders, the user's loop (``accumulate``, ``backward``,
``clip_grad_norm_``, ``save_state``/``load_state``) and the fused
``compile_train_step``, over the chunked LM-head loss, with attention on
hand-written Hopper flash-attention kernels, forward and backward. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .accelerator import AcceleratedModel, Accelerator
from .checkpointing import load_safetensors_model, save_model
from .data_loader import (
    AsyncPrefetcher,
    BatchSamplerShard,
    DataLoaderShard,
    NumpyDataLoader,
    SeedableRandomSampler,
    SkipBatchSampler,
    SkipDataLoader,
    default_collate,
    make_global_batch,
    pack_sequences,
    prepare_data_loader,
    skip_first_batches,
)
from .generation import (
    assisted_generate,
    beam_search_generate,
    generate,
    greedy_generate,
    prompt_lookup_generate,
    speculative_accept,
    speculative_emit,
)
from .logging import get_logger
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
from .parallel.sharding import resolve_remat_policy
from .precision import GradScalerKwargs, Policy, policy_for
from .scheduler import AcceleratedScheduler, LRScheduler
from .state import AcceleratorState, GradientState, PartialState
from .tracking import GeneralTracker, JSONLTracker, TensorBoardTracker
from .utils.convert import flax_from_state_dict, state_dict_from_flax
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    ProfileKwargs,
    ProjectConfiguration,
)
from .utils.device import resolve_device
from .utils.memory import find_executable_batch_size, release_memory
from .utils.profiling import ProfileSession, annotate, save_device_memory_profile
from .utils.random import set_seed
