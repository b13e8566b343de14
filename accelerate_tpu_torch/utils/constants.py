"""Names of the files a checkpoint holds.

Counterpart of ``accelerate_tpu/utils/constants.py`` (the checkpoint names,
``:9-23``, and ``WEIGHTS_PATTERN``). The mesh-axis names of the JAX package
have no counterpart on one GPU.
"""

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
DATALOADER_NAME = "dataloader"
RNG_STATE_NAME = "random_states"
CUSTOM_OBJECTS_NAME = "custom_checkpoint"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"

# Directory layout of Accelerator.save_state with automatic naming.
CHECKPOINT_DIR_PREFIX = "checkpoint"

WEIGHTS_PATTERN = "model-{:05d}-of-{:05d}.safetensors"
