"""The device mesh over the process group (``parallel/mesh.py``) and the
state that resolves it (``state.py``), against the JAX package.

* ``MeshConfig.axis_sizes`` over a table of cases, errors included, and
  ``from_env``, ``non_trivial_axes`` and ``str`` equal the JAX ones.
* Each rank's coordinates equal the place of JAX device ``r`` in
  ``MeshConfig.build``'s row-major layout (``np.array(devices).reshape``
  over ``("pp", "dp", "fsdp", "ep", "cp", "tp")``), and so does its data
  shard (its index over dp x fsdp).
* ``current_mesh`` resolves an explicit mesh, then a ``with mesh:`` block,
  then ``AcceleratorState().mesh``; the state puts the plugins' sizes on
  the mesh and names the governing ``distributed_type``; the TP, CP, PP
  and Megatron plugins (``to_plugins``,
  ``add_model_config_to_megatron_parser``) match the JAX package's.
"""

import dataclasses
import math

import numpy as np
import pytest

from accelerate_tpu_torch import MeshConfig
from accelerate_tpu_torch.parallel.mesh import Mesh, mesh_batch_size_multiple

SIZE_CASES = [
    (dict(), 8),
    (dict(fsdp=4), 8),
    (dict(dp=2, fsdp=2, tp=2), 8),
    (dict(dp=1, fsdp=-1, tp=2), 8),
    (dict(dp=1, cp=4), 8),
    (dict(dp=1, pp=2, tp=2), 4),
    (dict(fsdp=2, tp=2), 8),       # dp absorbs the remainder
    (dict(dp=-1, fsdp=-1), 8),     # two -1 axes
    (dict(dp=1, fsdp=3), 8),       # does not divide
    (dict(fsdp=3), 8),             # explicit axes do not divide
    (dict(dp=2, ep=4), 8),
    (dict(dp=1, ep=-1), 8),        # ep takes every process
]


def _jax_or_error(fn):
    try:
        return fn()
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("case", range(len(SIZE_CASES)))
def test_axis_sizes_equal_the_jax_ones(case):
    from accelerate_tpu import MeshConfig as JaxMeshConfig

    kwargs, n = SIZE_CASES[case]
    ours = _jax_or_error(lambda: MeshConfig(**kwargs).axis_sizes(n))
    theirs = _jax_or_error(lambda: JaxMeshConfig(**kwargs).axis_sizes(n))
    assert ours == theirs
    config, jconfig = MeshConfig(**kwargs), JaxMeshConfig(**kwargs)
    assert config.non_trivial_axes() == jconfig.non_trivial_axes()
    assert str(config) == str(jconfig)


def test_from_env_equals_the_jax_one(monkeypatch):
    from accelerate_tpu import MeshConfig as JaxMeshConfig

    for name, value in {"ACCELERATE_TPU_MESH_DP": "2", "ACCELERATE_TPU_MESH_TP": "4",
                        "ACCELERATE_TPU_MESH_CP": "1", "ACCELERATE_TPU_MESH_DCN_AXIS": "fsdp",
                        "ACCELERATE_TPU_MESH_ZERO_SHARDING": "1"}.items():
        monkeypatch.setenv(name, value)
    fields = [f.name for f in dataclasses.fields(JaxMeshConfig) if f.name != "devices"]
    ours, theirs = MeshConfig.from_env(), JaxMeshConfig.from_env()
    assert {f: getattr(ours, f) for f in fields} == {f: getattr(theirs, f) for f in fields}


@pytest.mark.parametrize("axes", [dict(dp=2, fsdp=2, tp=2), dict(pp=2, cp=2, tp=2),
                                  dict(dp=1, fsdp=4, tp=2), dict(pp=2, dp=2, cp=2),
                                  dict(dp=2, ep=2, tp=2), dict(fsdp=2, ep=2, cp=2)],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_rank_coordinates_follow_the_jax_device_layout(axes):
    import jax

    from accelerate_tpu import MeshConfig as JaxMeshConfig

    n = math.prod(axes.values())
    jmesh = JaxMeshConfig(**axes, devices=jax.devices()[:n]).build()
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(n):
        mesh = Mesh(MeshConfig(**axes).axis_sizes(n), list(range(n)), rank=r)
        assert mesh.shape == dict(jmesh.shape)
        want = dict(zip(jmesh.axis_names, (int(i) for i in np.argwhere(ids == r)[0])))
        assert mesh.coords == want
        assert mesh_batch_size_multiple(mesh) == mesh.shape["dp"] * mesh.shape["fsdp"]
        assert mesh.data_index() == mesh.coords["dp"] * mesh.shape["fsdp"] + mesh.coords["fsdp"]


def test_current_mesh_resolves_its_three_sources():
    from accelerate_tpu_torch.state import AcceleratorState, current_mesh

    assert current_mesh() is None
    state = AcceleratorState(cpu=True)
    assert current_mesh() is state.mesh
    inner = Mesh({"dp": 1}, [0])
    with inner:
        assert current_mesh() is inner
        explicit = Mesh({"tp": 1}, [0])
        assert current_mesh(explicit) is explicit
    assert current_mesh() is state.mesh


def test_state_puts_the_plugins_on_the_mesh():
    from accelerate_tpu_torch import (
        ContextParallelPlugin,
        MegatronLMPlugin,
        PipelineParallelPlugin,
        TensorParallelPlugin,
    )
    from accelerate_tpu_torch.state import AcceleratorState

    state = AcceleratorState(cpu=True, mesh_config=MeshConfig(dp=1, tp=1),
                             tp_plugin=TensorParallelPlugin(tp_size=1),
                             cp_plugin=ContextParallelPlugin(cp_size=1),
                             pp_plugin=PipelineParallelPlugin(pp_size=1))
    assert state.mesh.shape == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "cp": 1, "tp": 1}
    assert str(state.distributed_type) == "NO" and state.mesh_config.tp == 1
    AcceleratorState._reset_state()
    with pytest.raises(ValueError, match="not divisible"):
        AcceleratorState(cpu=True, tp_plugin=TensorParallelPlugin(tp_size=2))
    AcceleratorState._reset_state()
    state = AcceleratorState(cpu=True, megatron_lm_plugin=MegatronLMPlugin(
        use_distributed_optimizer=True))
    assert str(state.distributed_type) == "MEGATRON_LM"
    assert state.fsdp_plugin.sharding_strategy == "SHARD_GRAD_OP"


def test_parallelism_plugins_match_the_jax_ones():
    from accelerate_tpu.utils import dataclasses as jdc
    from accelerate_tpu_torch.utils import dataclasses as dc

    for name in ("TensorParallelPlugin", "ContextParallelPlugin", "PipelineParallelPlugin",
                 "MegatronLMPlugin"):
        ours, theirs = getattr(dc, name)(), getattr(jdc, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
    plugin = dc.MegatronLMPlugin(tp_degree=2, pp_degree=4, num_micro_batches=8,
                                 sequence_parallelism=True, use_distributed_optimizer=True)
    jplugin = jdc.MegatronLMPlugin(**dataclasses.asdict(plugin))
    for ours, theirs in zip(plugin.to_plugins(), jplugin.to_plugins()):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    config = {"hidden_size": 64, "num_hidden_layers": 8, "num_attention_heads": 4,
              "vocab_size": 256, "max_position_embeddings": 128}
    assert dc.add_model_config_to_megatron_parser(config, plugin)[1] == \
        jdc.add_model_config_to_megatron_parser(config, jplugin)[1]
    for bad in (dict(hidden_size=63), dict(num_attention_heads=3), dict(num_hidden_layers=6)):
        with pytest.raises(ValueError) as ours:
            dc.add_model_config_to_megatron_parser({**config, **bad}, plugin)
        with pytest.raises(ValueError) as theirs:
            jdc.add_model_config_to_megatron_parser({**config, **bad}, jplugin)
        assert str(ours.value) == str(theirs.value)
