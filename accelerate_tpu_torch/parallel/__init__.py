from .mesh import MeshConfig, make_mesh, mesh_batch_size_multiple
from .pipeline import pipeline_apply, stack_layer_params, unstack_layer_params
from .sharding import (
    RematPolicy,
    ShardingRules,
    infer_param_shardings,
    resolve_remat_policy,
    shard_params,
    sharding_summary,
)
