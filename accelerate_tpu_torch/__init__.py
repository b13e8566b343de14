"""PyTorch/CUDA port of accelerate_tpu for NVIDIA Hopper (H100).

A self-contained package beside ``accelerate_tpu`` (the JAX reference,
which it never imports). It holds the Llama forward, KV-cached
``generate``, the speculative decoders (``prompt_lookup_generate``,
``assisted_generate``) and ``beam_search_generate``, and training: ``Accelerator.prepare`` of models, optimizers,
schedulers and data loaders, the user's loop (``accumulate``, ``backward``,
``clip_grad_norm_``, ``save_state``/``load_state``) and the fused
``compile_train_step``, over the chunked LM-head loss, with attention on
hand-written Hopper flash-attention kernels, forward and backward, and the
continuous-batching ``ServingEngine`` (chunked or monolithic prefill, paged
KV in the cache dtype or int8, prefix cache, async ticks, draft-model and
prompt-lookup speculation, sliding-window page freeing, multi-tenant LoRA
adapters over full-precision or int8 base weights) on fixed-shape steps
under CUDA graphs, with the fleet in front of it (``serving``: the replica
router with failover, the supervisor, scripted faults, the HTTP gateway;
``loadgen``; the ``accelerate-tpu-torch serve``/``loadtest`` commands), and
big-model inference (``big_modeling``: the device-map solver over card,
host and disk, ``StreamedModel`` streaming a model's blocks onto the card,
HF-layout checkpoints of the Llama, MoE and GPT-style families, T5, BERT
and ViT, quantized loading), the other model families (``models``: GPT-2, OPT,
GPT-J, GPT-NeoX, Phi, BLOOM, BERT, ResNet, the small models, and the
encoder-decoder T5 with ``seq2seq_generate`` and ViT), fp8 training
(``use_fp8``: delayed-scaling projections on ``torch._scaled_mm``,
``ops/quant.py``), ``estimate-memory``, the native host IO (``native/``),
and
several processes: process groups over NCCL (one card a process) or gloo
(the CPU), the collectives, sharded and dispatched loaders, data-parallel
training with the gradients reduced at each sync step, ``LocalSGD``, the
in-process launchers and ``accelerate-tpu-torch launch``/``env``/``test``/
``config default``, and device meshes over the process group with
in-model parallelism: 2-D FSDP and ``HYBRID_SHARD``, tensor, context (ring
and Ulysses) and pipeline parallelism, and pipelined inference
(``parallel/mesh.py``, ``inference.py``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``cpu=True``, or ``launch --use_cpu_emulation``).
"""

from .accelerator import AcceleratedModel, Accelerator
from .adapters import (
    AdapterBank,
    AdapterBankFull,
    LoRAConfig,
    LoRATrainState,
    UnknownAdapterError,
    init_lora_params,
    merge_adapter,
    prepare_lora,
    quantize_base_weights,
)
from .big_modeling import (
    BlockSpec,
    LazyStack,
    LazyWeight,
    StreamedModel,
    UserCpuOffloadHook,
    WeightStore,
    block_specs_for,
    cpu_offload,
    cpu_offload_with_hook,
    disk_offload,
    dispatch_model,
    init_empty_weights,
    init_on_device,
    load_checkpoint_and_dispatch,
    load_checkpoint_in_model,
    load_hf_checkpoint_and_dispatch,
    store_from_params,
)
from .checkpointing import (
    SafetensorsFile,
    checkpoint_shards,
    load_adapter,
    load_safetensors_model,
    save_adapter,
    save_model,
)
from .data_loader import (
    AsyncPrefetcher,
    BatchSamplerShard,
    DataLoaderDispatcher,
    DataLoaderShard,
    IterableDatasetShard,
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
    seq2seq_generate,
    speculative_accept,
    speculative_emit,
    speculative_emit_keyed,
)
from .launchers import debug_launcher, notebook_launcher
from .local_sgd import LocalSGD
from .logging import get_logger
from .models import (
    MLP,
    BertConfig,
    BertForSequenceClassification,
    BloomConfig,
    BloomForCausalLM,
    GPT2Config,
    GPT2LMHeadModel,
    GPTJConfig,
    GPTJForCausalLM,
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
    OPTConfig,
    OPTForCausalLM,
    PhiConfig,
    PhiForCausalLM,
    RegressionModel,
    ResNet,
    ResNetConfig,
    T5Config,
    T5ForConditionalGeneration,
    ViTConfig,
    ViTForImageClassification,
    classification_loss,
    seq2seq_lm_loss,
)
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
from .inference import PipelinedInferencer, prepare_pipeline, prepare_pippy
from .parallel.mesh import MeshConfig, make_mesh
from .parallel.sharding import resolve_remat_policy
from .precision import GradScalerKwargs, Policy, policy_for
from .scheduler import AcceleratedScheduler, LRScheduler
from .serving import Request, RequestStatus, ServingEngine, ServingStats
from .state import AcceleratorState, GradientState, PartialState
from .tracking import GeneralTracker, JSONLTracker, TensorBoardTracker
from .utils.convert import flax_from_state_dict, state_dict_from_flax
from .utils.hf_interop import (
    config_from_hf,
    convert_hf_state_dict,
    export_hf_state_dict,
    load_hf_checkpoint,
    save_hf_checkpoint,
)
from .utils.dataclasses import (
    AutocastKwargs,
    ContextParallelPlugin,
    DataLoaderConfiguration,
    DDPCommunicationHookType,
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    DistributedInitKwargs,
    DistributedType,
    ExpertParallelPlugin,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    MegatronLMPlugin,
    PipelineParallelPlugin,
    ProfileKwargs,
    ProjectConfiguration,
    TensorParallelPlugin,
)
from .utils.device import resolve_device
from .utils.memory import find_executable_batch_size, release_memory
from .utils.modeling import (
    calculate_maximum_sizes,
    check_device_map,
    compute_module_sizes,
    get_balanced_memory,
    get_max_memory,
    infer_auto_device_map,
)
from .utils.offload import OffloadedWeightsLoader, offload_state_dict
from .utils.profiling import (
    GraphCaptureWatcher,
    ProfileSession,
    annotate,
    save_device_memory_profile,
)
from .utils.quantization import (
    QuantizationConfig,
    QuantizedTensor,
    dequantize_params,
    load_and_quantize_hf_checkpoint,
    load_and_quantize_model,
    quantize_params,
    quantize_tensor,
)
from .utils.imports import is_rich_available
from .utils.random import set_seed, synchronize_rng_states

if is_rich_available():
    from .utils import rich  # noqa: F401
