"""Names of the files a checkpoint holds, and of the environment variables.

Counterpart of ``accelerate_tpu/utils/constants.py`` (the checkpoint names,
``:9-23``, ``WEIGHTS_PATTERN`` and ``ENV_PREFIX``) and the mesh-axis
names (``:43-52``); ``env_var`` is re-exported from ``environment.py``.
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

# Environment variables the launcher sets and the state reads share this
# prefix, the JAX package's, so one launched script configures either.
ENV_PREFIX = "ACCELERATE_TPU_"

# Mesh axis names (parallel/mesh.py). Every layout in the package is
# expressed over these axes:
#   dp    - data parallelism (gradients summed, parameters replicated)
#   fsdp  - fully-sharded data parallelism (parameters, gradients and
#           optimizer state sharded)
#   tp    - tensor parallelism (Megatron column/row projections)
#   cp    - context parallelism (the sequence split; ring or Ulysses
#           attention)
#   ep    - expert parallelism (MoE)
#   pp    - pipeline stages
MESH_AXIS_DP = "dp"
MESH_AXIS_FSDP = "fsdp"
MESH_AXIS_TP = "tp"
MESH_AXIS_CP = "cp"
MESH_AXIS_EP = "ep"
MESH_AXIS_PP = "pp"
MESH_AXES = (MESH_AXIS_DP, MESH_AXIS_FSDP, MESH_AXIS_TP, MESH_AXIS_CP, MESH_AXIS_EP, MESH_AXIS_PP)

# Axes over which a global batch's rows are split.
BATCH_AXES = (MESH_AXIS_DP, MESH_AXIS_FSDP)



def __getattr__(name):
    # ``env_var`` lives in ``environment.py`` (which reads ENV_PREFIX from
    # here); ``from .constants import env_var`` still finds it.
    if name == "env_var":
        from .environment import env_var

        return env_var
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
