"""The one-process ground of several processes, against the JAX package on
the same inputs: the environment parsers, the small helpers, the
one-process operations, the enums and handlers, the launch configuration
file both ways, the sharding of loaders and of inputs seen from each rank
of a world, and the two faults the re-anchor found (the scheduler's
``get_lr`` and pass-through, and the missing public names).

Exact equality throughout: none of these computes in floating point
beyond copying values.
"""

import os

import numpy as np
import pytest
import torch

import accelerate_tpu.utils as jutils
import accelerate_tpu_torch.utils as tutils
from accelerate_tpu.utils import operations as jops
from accelerate_tpu_torch.utils import operations as tops


def host(x):
    """Nested tensors/arrays as nested numpy arrays, for comparing."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(a, b):
    a, b = host(a), host(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind


def batch():
    rng = np.random.default_rng(0)
    return {"b": rng.normal(size=(5, 3)).astype(np.float32),
            "a": [rng.integers(0, 9, (6,)).astype(np.int64), np.zeros((6, 2), np.float32)]}


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


HELPERS = {
    "find_batch_size": lambda ops, t: ops.find_batch_size(t),
    "ignorant_find_batch_size": lambda ops, t: ops.ignorant_find_batch_size(t),
    "get_shape": lambda ops, t: ops.get_shape(t),
    "slice_tensors": lambda ops, t: ops.slice_tensors(t, slice(1, 4)),
    "pad_input_tensors": lambda ops, t: ops.pad_input_tensors(t, 5, 4),
    "listify": lambda ops, t: ops.listify(t),
    "initialize_tensors": lambda ops, t: ops.initialize_tensors(ops.get_data_structure(t)),
    "concatenate": lambda ops, t: ops.concatenate([t["a"], t["a"]]),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_one_process_helper_matches_the_reference(name):
    data = batch()
    ref = HELPERS[name](jops, data)
    got = HELPERS[name](tops, as_torch(data))
    if isinstance(ref, (int, type(None))) or name in ("get_shape", "listify"):
        assert got == ref
    else:
        assert_same(got, ref)


def test_data_structure_and_fp32_conversion_match_the_reference():
    import jax.numpy as jnp

    data = batch()
    ref = jops.get_data_structure(data)
    got = tops.get_data_structure(as_torch(data))
    assert tuple(got["b"].shape) == ref["b"].shape and got["b"].dtype == torch.float32
    assert [tuple(s.shape) for s in got["a"]] == [s.shape for s in ref["a"]]
    half = {"h": np.ones((2,), np.float16), "i": np.arange(3)}
    ref16 = jops.convert_to_fp32({"h": jnp.asarray(half["h"], jnp.bfloat16), "i": half["i"]})
    got16 = tops.convert_to_fp32({"h": torch.ones(2, dtype=torch.bfloat16),
                                  "i": torch.arange(3)})
    assert got16["h"].dtype == torch.float32 and str(ref16["h"].dtype) == "float32"
    assert got16["i"].dtype == torch.int64
    wrapped = tops.convert_outputs_to_fp32(lambda x: x.half())
    assert wrapped(torch.ones(2)).dtype == torch.float32
    assert tops.find_device(as_torch(data)) == torch.device("cpu")


def test_collectives_are_identities_without_a_process_group():
    t = torch.arange(4.0)
    assert tops.gather(t) is t and tops.broadcast(t) is t
    assert tops.pad_across_processes(t) is t
    assert tops.broadcast_object_list([1, "a"]) == [1, "a"]
    assert tops.gather_object(3) == jops.gather_object(3) == [3]
    assert tops.gather_object([1, 2]) == jops.gather_object([1, 2]) == [1, 2]
    assert torch.equal(tops.reduce(t, "mean", scale=2.0), t * 2)


@pytest.mark.parametrize("value", ["1", "yes", "On", "false", "0", "n", "maybe"])
def test_environment_parsers_match_the_reference(monkeypatch, value):
    monkeypatch.setenv("ATPU_T_FLAG", value)
    for fn in ("parse_flag_from_env", "parse_choice_from_env"):
        outcome = []
        for mod in (jutils, tutils):
            try:
                outcome.append(getattr(mod, fn)("ATPU_T_FLAG"))
            except ValueError as e:
                outcome.append(type(e))
        assert outcome[0] == outcome[1], fn
    monkeypatch.setenv("ATPU_T_INT", "7")
    from accelerate_tpu.utils.environment import get_int_from_env as jget
    from accelerate_tpu_torch.utils.environment import get_int_from_env as tget

    keys = ["ATPU_T_MISSING", "ATPU_T_INT"]
    assert tget(keys, 3) == jget(keys, 3) == 7


def test_patch_and_clear_environment_match_the_reference(monkeypatch):
    monkeypatch.setenv("ATPU_T_KEEP", "old")
    seen = []
    for mod in (jutils, tutils):
        with mod.patch_environment(atpu_t_keep="new", atpu_t_added=1):
            seen.append((os.environ["ATPU_T_KEEP"], os.environ["ATPU_T_ADDED"]))
        seen.append((os.environ["ATPU_T_KEEP"], os.environ.get("ATPU_T_ADDED")))
        with mod.clear_environment():
            seen.append(len(os.environ))
        seen.append(os.environ["ATPU_T_KEEP"])
    assert seen[:4] == seen[4:] == [("new", "1"), ("old", None), 0, "old"]


def test_small_helpers_match_the_reference():
    class Node:
        class inner:
            leaf = 5

    for mod in (jutils, tutils):
        assert mod.merge_dicts({"a": {"b": 1}, "c": 2}, {"a": {"d": 3}}) == \
            {"a": {"d": 3, "b": 1}, "c": 2}
        assert [mod.convert_bytes(n) for n in (10, 2048, 3 * 2**30)] == \
            ["10 B", "2.0 KB", "3.0 GB"]
        assert mod.recursive_getattr(Node, "inner.leaf") == 5
        assert mod.get_pretty_name(Node) == "test_small_helpers_match_the_reference.<locals>.Node"
        assert mod.get_pretty_name(Node()) == mod.get_pretty_name(Node)
        assert mod.compare_versions("numpy", ">=", "1.0")
        assert not mod.compare_versions("numpy", "<", "1.0")
        assert mod.str_to_bool("TRUE") == 1
        assert mod.are_libraries_initialized("os", "not_a_module_x") == ["os"]
    assert tutils.is_torch_version(">=", "2.0") and not tutils.is_cuda_available()
    assert tutils.get_gpu_info() == ([], 0) and tutils.is_multi_host() is False
    assert tutils.check_os_kernel() == jutils.check_os_kernel()


def test_extract_model_and_save(tmp_path):
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(2, 2)
    model = acc.prepare(module)
    assert tutils.extract_model_from_parallel(model) is module
    assert acc.unwrap_model(model) is module
    tied = {"w": module.weight, "w_again": module.weight, "b": module.bias}
    assert list(tutils.clean_state_dict_for_safetensors(tied)) == ["w", "b"]
    tutils.save(tied, tmp_path / "m.safetensors", safe_serialization=True)
    tutils.save({"step": 3}, tmp_path / "s.pkl")
    from safetensors.torch import load_file

    assert set(load_file(tmp_path / "m.safetensors")) == {"w", "b"}
    with pytest.raises(TypeError, match="not a tensor"):
        tutils.clean_state_dict_for_safetensors({"x": "text"})
    from accelerate_tpu_torch.state import PartialState

    PartialState._shared_state["process_index"] = 1  # as rank 1 of a world
    PartialState._shared_state["local_process_index"] = 1
    tutils.save({"step": 4}, tmp_path / "rank1.pkl")
    assert not (tmp_path / "rank1.pkl").exists()
    from accelerate_tpu_torch.utils.tqdm import tqdm

    assert tqdm(range(3)).disable and not tqdm(range(3), main_process_only=False).disable


def test_enums_and_handlers():
    from accelerate_tpu.utils.dataclasses import DistributedInitKwargs as JaxInit

    assert tutils.DistributedType.MULTI_GPU == "MULTI_GPU" and "MULTI_CPU" in tutils.DistributedType
    assert tutils.PrecisionType.list() == jutils.PrecisionType.list()
    assert tutils.LoggerType.list() == jutils.LoggerType.list()
    assert tutils.CustomDtype.list() == jutils.CustomDtype.list()
    assert {"numpy", "python", "generator"} <= set(tutils.RNGType.list())
    assert tutils.InitProcessGroupKwargs is tutils.DistributedInitKwargs
    fields = ("coordinator_address", "num_processes", "process_id", "local_device_ids",
              "initialization_timeout")
    assert tuple(tutils.DistributedInitKwargs.__dataclass_fields__) == fields
    assert tuple(JaxInit.__dataclass_fields__) == fields
    assert tutils.DistributedInitKwargs(num_processes=2).to_kwargs() == {"num_processes": 2}
    assert tutils.DistributedDataParallelKwargs(bucket_cap_mb=1).to_kwargs() == \
        {"bucket_cap_mb": 1}
    with pytest.warns(UserWarning, match="static_graph"):
        tutils.DistributedDataParallelKwargs(static_graph=True)
    with pytest.raises(ValueError, match="bucket_cap_mb"):
        tutils.DistributedDataParallelKwargs(bucket_cap_mb=0)


@pytest.mark.parametrize("direction", ["jax-writes", "port-writes"])
def test_cluster_config_files_interchange(tmp_path, direction, monkeypatch):
    from accelerate_tpu.commands.config.config_args import ClusterConfig as JaxConfig
    from accelerate_tpu.commands.config.config_args import load_config_from_file as jload
    from accelerate_tpu_torch.commands.config.config_args import ClusterConfig
    from accelerate_tpu_torch.commands.config.config_args import load_config_from_file

    values = dict(mixed_precision="bf16", debug=True, num_machines=2, machine_rank=1,
                  main_process_ip="10.0.0.2", main_process_port=1234, use_cpu_emulation=True)
    path = tmp_path / "cfg.yaml"
    if direction == "jax-writes":
        JaxConfig(**values).save(str(path))
        cfg = load_config_from_file(str(path))
        import sys

        monkeypatch.setitem(sys.modules, "yaml", None)  # the flat reader, as on the card
        flat = load_config_from_file(str(path))
        assert flat.to_dict() == cfg.to_dict()
    else:
        ClusterConfig(**values).save(str(path))
        cfg = jload(str(path))
    for key, value in values.items():
        assert getattr(cfg, key) == value, key
    assert cfg.extra == {}


def test_reference_config_is_migrated(tmp_path):
    from accelerate_tpu_torch.commands.config.config_args import load_config_from_file

    path = tmp_path / "hf.yaml"
    path.write_text("distributed_type: MULTI_GPU\nuse_cpu: true\nnum_processes: 4\n"
                    "mixed_precision: fp16\ngpu_ids: all\n")
    cfg = load_config_from_file(str(path))
    assert cfg.use_cpu_emulation and cfg.mixed_precision == "fp16"
    assert cfg.extra == {"num_processes": 4, "gpu_ids": "all"}
    assert any("num_processes" in note for note in cfg.migration_notes)


@pytest.mark.parametrize("n,i,bs,drop_last,split", [
    (2, 0, 3, False, False), (2, 1, 3, False, False), (3, 2, 2, True, False),
    (2, 1, 4, False, True)])
def test_iterable_dataset_shard_matches_the_reference(n, i, bs, drop_last, split):
    from accelerate_tpu.data_loader import IterableDatasetShard as JaxShard
    from accelerate_tpu_torch.data_loader import IterableDatasetShard

    data = list(range(17))
    kw = dict(batch_size=bs, drop_last=drop_last, num_processes=n, process_index=i,
              split_batches=split)
    ref = JaxShard(data, **kw)
    got = IterableDatasetShard(data, **kw)
    assert list(got) == list(ref) and len(got) == len(ref)


@pytest.mark.parametrize("split,even", [(False, True), (False, False), (True, True)])
def test_sharded_numpy_loader_matches_the_reference_on_every_rank(split, even):
    """Each rank's batches of ``prepare_data_loader(num_processes=2,
    process_index=r)``, from one process, equal the JAX package's."""
    from accelerate_tpu.data_loader import NumpyDataLoader as JaxLoader
    from accelerate_tpu.data_loader import prepare_data_loader as jprepare
    from accelerate_tpu_torch.data_loader import NumpyDataLoader, prepare_data_loader
    from accelerate_tpu_torch.state import PartialState

    PartialState(cpu=True)
    rows = [{"x": np.array([r], np.int64)} for r in range(19)]
    for rank in range(2):
        kw = dict(num_processes=2, process_index=rank, split_batches=split, even_batches=even,
                  put_on_device=False)
        ref = jprepare(JaxLoader(rows, batch_size=4, shuffle=True, seed=3), **kw)
        got = prepare_data_loader(NumpyDataLoader(rows, batch_size=4, shuffle=True, seed=3),
                                  device="cpu", **kw)
        want = [b["x"].reshape(-1).tolist() for b in ref.base_dataloader]
        assert [b["x"].reshape(-1).tolist() for b in got.base_dataloader] == want
        assert got.total_batch_size == ref.total_batch_size


@pytest.mark.parametrize("apply_padding", [False, True])
def test_split_between_processes_matches_the_reference_on_every_rank(apply_padding):
    from accelerate_tpu.state import PartialState as JaxState
    from accelerate_tpu_torch.state import PartialState

    jax_state, state = JaxState(), PartialState(cpu=True)
    try:
        for rank in range(3):
            for s in (jax_state, state):
                s._shared_state.update(num_processes=3, process_index=rank)
            with jax_state.split_between_processes(list(range(7)), apply_padding) as ref, \
                    state.split_between_processes(list(range(7)), apply_padding) as got:
                assert list(got) == list(ref)
            array = np.arange(14).reshape(7, 2)
            with jax_state.split_between_processes(array, apply_padding) as ref_a, \
                    state.split_between_processes(array, apply_padding) as got_a:
                np.testing.assert_array_equal(got_a, ref_a)
            with state.split_between_processes(torch.from_numpy(array), apply_padding) as t:
                np.testing.assert_array_equal(t.numpy(), ref_a)
            # A dict splits each value by the values' length (the reference
            # splits by the number of keys).
            with state.split_between_processes({"l": list(range(7))}, apply_padding) as d:
                assert list(d["l"]) == list(ref)
    finally:
        JaxState._reset_state()


def test_scheduler_get_lr_and_passthrough_match_the_reference():
    """C1: ``get_lr()``, ``.last_epoch`` and ``.base_lrs`` of both packages'
    prepared schedulers over one torch ``StepLR``."""
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu_torch import Accelerator

    def sched():
        opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.5)
        return torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.1)

    ref = JaxAccelerator().prepare(sched())
    got = Accelerator(cpu=True).prepare(sched())
    for _ in range(3):
        ref.step()
        got.step()
        assert got.get_lr() == ref.get_lr()
        assert got.last_epoch == ref.last_epoch and got.base_lrs == ref.base_lrs == [0.5]
        assert got.get_last_lr() == ref.get_last_lr()
    with pytest.raises(AttributeError):
        got.no_such_attribute


def test_new_public_names_of_the_re_anchor(tmp_path):
    """C2: the names the port lacked behave as the reference's."""
    from accelerate_tpu import tracking as jtracking
    from accelerate_tpu.utils.modeling import compute_module_sizes as jsizes
    from accelerate_tpu.utils.modeling import infer_auto_device_map as jmap
    from accelerate_tpu.utils.profiling import PipelineStats as JaxStats
    from accelerate_tpu_torch import Accelerator, LlamaConfig, LlamaForCausalLM, tracking
    from accelerate_tpu_torch.checkpointing import load_safetensors_model, save_model
    from accelerate_tpu_torch.generation import supports_kv_cache
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes, infer_auto_device_map
    from accelerate_tpu_torch.utils.profiling import PipelineStats

    class Fleet:
        def fleet_metrics(self):
            return {"fleet_failovers": 2, "ttft_ms": 1.5}

    assert tracking.with_fleet_metrics({"ttft_ms": 9}, Fleet()) == \
        jtracking.with_fleet_metrics({"ttft_ms": 9}, Fleet())
    stats = []
    for cls in (JaxStats, PipelineStats):
        a, b = cls(), cls()
        a.record_wait(2.0)
        b.record_wait(4.0)
        b.record_stage(1.0)
        b.record_depth(3)
        stats.append(a.merge(b).summary())
    assert stats[0] == stats[1]
    acc = Accelerator(cpu=True)
    assert acc.state.on_last_process(lambda: 7)() == 7
    assert supports_kv_cache(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    assert not supports_kv_cache(torch.nn.Linear(2, 2))
    tree = {"layer": {"w": np.zeros((4, 4), np.float32), "b": np.zeros((4,), np.float32)}}
    assert compute_module_sizes(as_torch(tree), prefix="m.") == jsizes(tree, prefix="m.")
    budget = {0: 60, "cpu": 10**6}
    assert dict(infer_auto_device_map(as_torch(tree), max_memory=budget,
                                      offload_buffers=True)) == \
        dict(jmap(tree, max_memory=budget, offload_buffers=True))
    module = torch.nn.Linear(3, 2)
    save_model(acc, module, str(tmp_path))  # the reference's positional order
    assert set(load_safetensors_model(str(tmp_path))) == {"weight", "bias"}
