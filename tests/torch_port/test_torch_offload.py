"""Size math, the device-map solver, offload folders and the lazy
safetensors reader of the port, held against the JAX package.

The solver's numbers and maps must be equal, not close: both packages see
the same shapes in the same order (names mapped ``layers.<i>`` <->
``layers_<i>``, ``weight`` <-> ``kernel``/``embedding``). Offload folders
cross between the packages bit for bit, bf16 included."""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from accelerate_tpu.utils import modeling as jm
from accelerate_tpu.utils import offload as joff
from accelerate_tpu_torch import LlamaForCausalLM, init_empty_weights
from accelerate_tpu_torch.checkpointing import (
    SafetensorsFile,
    checkpoint_shards,
    load_safetensors,
    save_model,
)
from accelerate_tpu_torch.utils import modeling as pm
from accelerate_tpu_torch.utils import offload as poff

from torch_big_model_common import jax_name, jax_params


def port_meta(config):
    with init_empty_weights():
        return LlamaForCausalLM(config)


@pytest.fixture(scope="module")
def pair():
    """(port meta model, JAX params) of one tiny Llama, untied."""
    cfg, _, _, params = jax_params("llama", num_hidden_layers=3)
    return port_meta(cfg), params


@pytest.fixture(scope="module")
def tied_pair():
    cfg, _, _, params = jax_params("gemma", num_hidden_layers=2)
    return port_meta(cfg), params


def test_parse_size_and_dtype_bytes_agree():
    for size in ("1KB", "2MB", "1.5GB", "512MiB", "3TB", 123, "77"):
        assert pm.parse_size(size) == jm.parse_size(size)
    assert pm.dtype_byte_size(torch.float32) == jm.dtype_byte_size(jnp.float32) == 4
    assert pm.dtype_byte_size(torch.bfloat16) == jm.dtype_byte_size(jnp.bfloat16) == 2
    assert pm.dtype_byte_size(torch.int8) == jm.dtype_byte_size(jnp.int8) == 1
    assert pm.dtype_byte_size("int4") == jm.dtype_byte_size("int4") == 0.5
    assert pm.dtype_byte_size("bfloat16") == 2


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_module_sizes_equal(pair, dtype):
    model, params = pair
    ours = pm.compute_module_sizes(model, dtype=getattr(torch, dtype) if dtype else None)
    ref = jm.compute_module_sizes(params, dtype=jnp.bfloat16 if dtype else None)
    # "model.layers" groups the layers here and has no JAX counterpart.
    assert {jax_name(k): v for k, v in ours.items() if k != "model.layers"} == ref
    assert pm.compute_module_total_buffer_size(model) == jm.compute_module_total_buffer_size(params)


def test_named_parameters_natural_order(pair):
    model, params = pair
    assert [jax_name(n) for n in pm.named_parameters(model)] == list(jm.named_parameters(params))
    tree = {"layers": {"10": {"w": torch.zeros(1)}, "2": {"w": torch.zeros(1)},
                       "1": {"w": torch.zeros(1)}}}
    assert list(pm.named_parameters(tree)) == ["layers.1.w", "layers.2.w", "layers.10.w"]


def test_calculate_maximum_sizes_equal(pair):
    model, params = pair
    ours = pm.calculate_maximum_sizes(model, no_split=["LlamaBlock"])
    ref = jm.calculate_maximum_sizes(params, no_split=[r"layers_\d+"])
    assert ours[0] == ref[0] and ours[1][0] == ref[1][0]
    assert jax_name(ours[1][1]) == ref[1][1]
    assert pm.calculate_maximum_sizes(model) == (ref[0], (jm.calculate_maximum_sizes(params)[1][0],
                                                          "lm_head.weight"))


def _budgets(sizes, layer, embed):
    """Budgets that put a few units on the card, some on the host and the
    rest on disk, at several cut points."""
    return [
        {0: sizes[""] * 2, "cpu": 0},
        {0: embed + 2 * layer, "cpu": layer + layer // 2},
        {0: embed + 3 * layer, "cpu": 2 * layer},
        {0: layer, "cpu": layer},
        {0: 2 * embed + layer + 1000, "cpu": 10 * layer},
        {"cpu": embed + layer},
    ]


@pytest.mark.parametrize("no_split", [None, ["LlamaBlock"], [r"model\.layers\.\d+"]])
def test_device_maps_equal(pair, no_split):
    model, params = pair
    sizes = pm.compute_module_sizes(model)
    jax_no_split = None if no_split is None else [r"layers_\d+"]
    for budget in _budgets(sizes, sizes["model.layers.0"], sizes["model.embed_tokens"]):
        ours = pm.infer_auto_device_map(model, max_memory=budget, no_split_module_classes=no_split)
        ref = jm.infer_auto_device_map(params, max_memory=budget,
                                       no_split_module_classes=jax_no_split)
        assert [(jax_name(k), v) for k, v in ours.items()] == list(ref.items()), budget
        pm.check_device_map(model, ours)
        values = set(ours.values())
        assert values <= {0, "cpu", "disk"}


def test_device_maps_equal_with_tied_embeddings(tied_pair):
    model, params = tied_pair
    sizes = pm.compute_module_sizes(model)
    for budget in _budgets(sizes, sizes["model.layers.0"], sizes["model.embed_tokens"]):
        ours = pm.infer_auto_device_map(model, max_memory=budget,
                                        no_split_module_classes=["LlamaBlock"])
        ref = jm.infer_auto_device_map(params, max_memory=budget,
                                       no_split_module_classes=[r"layers_\d+"])
        assert [(jax_name(k), v) for k, v in ours.items()] == list(ref.items())


def test_tied_parameters_counted_once_and_ride_along():
    shared = torch.ones((16, 32))
    params = {"embed": {"tok": {"weight": shared}}, "head": {"lm": {"weight": shared}}}
    assert pm.find_tied_parameters(params) == [["embed.tok.weight", "head.lm.weight"]]
    dm = pm.infer_auto_device_map(params, max_memory={0: 3000, "cpu": 10_000})
    jshared = np.ones((16, 32), np.float32)
    ref = jm.infer_auto_device_map(
        {"embed": {"tok": {"embedding": jshared}}, "head": {"lm": {"kernel": jshared}}},
        max_memory={0: 3000, "cpu": 10_000},
        tied_parameters=[["embed.tok.embedding", "head.lm.kernel"]])
    assert list(dm.values()) == list(ref.values()) == [0, 0]


def test_balanced_memory_and_budgets_equal(pair):
    model, params = pair
    budget = {0: 1 << 40, 1: 1 << 40, "cpu": 1 << 30}
    for low_zero in (False, True):
        ours = pm.get_balanced_memory(model, max_memory=budget, low_zero=low_zero,
                                      no_split_module_classes=["LlamaBlock"])
        ref = jm.get_balanced_memory(params, max_memory=budget, low_zero=low_zero,
                                     no_split_module_classes=[r"layers_\d+"])
        assert dict(ours) == dict(ref)
        if not low_zero:  # forced to spread
            assert max(ours[0], ours[1]) < pm.compute_module_sizes(model)[""]
        else:
            assert ours[0] < ours[1]
    ours = pm.get_max_memory({0: "1MB", "cpu": "2MB"})
    assert dict(ours) == dict(jm.get_max_memory({0: "1MB", "cpu": "2MB"}))
    assert ours[0] == 2**20 and ours["cpu"] == 2 * 2**20 and ours["disk"] > 2**40


def test_max_memory_without_a_card_plans_host_and_disk():
    budgets = pm.get_max_memory()
    assert list(budgets) == ["cpu", "disk"] and budgets["cpu"] > 0


def test_check_device_map_refuses_a_gap(pair):
    model, _ = pair
    with pytest.raises(ValueError, match="not covered"):
        pm.check_device_map(model, {"model": 0})


# -- offload folders -------------------------------------------------------

def test_port_folder_reads_in_jax(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"w": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)).bfloat16(),
               "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "s": torch.tensor(2.5)}
    poff.offload_state_dict(str(tmp_path), tensors)
    index = joff.load_offload_index(str(tmp_path))
    for name, t in tensors.items():
        got = np.asarray(joff.load_offloaded_weight(str(tmp_path / f"{name}.dat"), index[name]))
        want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert got.shape == tuple(t.shape)
        np.testing.assert_array_equal(got.astype(np.float32) if t.dtype == torch.bfloat16
                                      else got, want)
        if t.dtype == torch.bfloat16:
            assert got.dtype == ml_dtypes.bfloat16


def test_jax_folder_reads_in_port(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "b": jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16),
              "h": rng.standard_normal(5).astype(np.float16)}
    joff.offload_state_dict(str(tmp_path), arrays)
    loader = poff.OffloadedWeightsLoader(state_dict={"x": torch.zeros(2)},
                                         offload_folder=str(tmp_path))
    assert set(loader) == {"w", "b", "h", "x"} and len(loader) == 4
    for name, arr in arrays.items():
        got = loader[name]
        if name == "b":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(arr, np.float32))
        else:
            np.testing.assert_array_equal(got.numpy(), arr)
    assert torch.equal(loader["x"], torch.zeros(2))


def test_offloaded_weight_is_copy_on_write(tmp_path):
    index = poff.offload_weight(torch.arange(4.0), "w", str(tmp_path))
    t = poff.load_offloaded_weight(str(tmp_path / "w.dat"), index["w"])
    t += 1
    again = poff.load_offloaded_weight(str(tmp_path / "w.dat"), index["w"])
    assert torch.equal(again, torch.arange(4.0))


# -- the lazy safetensors reader ---------------------------------------------

def test_reader_reads_one_tensor_at_its_offsets(tmp_path):
    rng = np.random.default_rng(2)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.integers(-9, 9, (5,)).astype(np.int8),
              "c": np.zeros((0, 2), np.float32),
              "d": rng.standard_normal((2, 2)).astype(np.float16)}
    save_file(arrays, str(tmp_path / "x.safetensors"), metadata={"format": "np"})
    f = SafetensorsFile(tmp_path / "x.safetensors")
    assert sorted(f.keys()) == sorted(arrays) and "a" in f and f.metadata == {"format": "np"}
    for name, arr in arrays.items():
        dtype, shape, nbytes = f.meta(name)
        assert shape == arr.shape and nbytes == arr.nbytes
        np.testing.assert_array_equal(f.read(name).numpy(), arr)
    assert {k: v.numpy().tolist() for k, v in load_safetensors(tmp_path / "x.safetensors").items()} \
        == {k: v.tolist() for k, v in arrays.items()}


def test_reader_refuses_a_truncated_file(tmp_path):
    save_file({"a": np.ones((64,), np.float32)}, str(tmp_path / "x.safetensors"))
    raw = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "x.safetensors").write_bytes(raw[:-16])
    with pytest.raises(ValueError, match="past the end"):
        SafetensorsFile(tmp_path / "x.safetensors").read("a")


def test_checkpoint_shards_of_a_file_a_directory_and_an_index(tmp_path):
    model = torch.nn.Linear(4, 3)
    save_model(None, model, str(tmp_path / "one"))
    save_model(None, model, str(tmp_path / "many"), max_shard_size="16")
    one = checkpoint_shards(tmp_path / "one")
    many = checkpoint_shards(tmp_path / "many")
    assert len(one) == 1 and len(many) == 2
    index = json.loads((tmp_path / "many" / "model.safetensors.index.json").read_text())
    assert sorted(os.path.basename(s.path) for s in many) == sorted(set(index["weight_map"].values()))
    assert len(checkpoint_shards(one[0].path)) == 1
    with pytest.raises(FileNotFoundError):
        checkpoint_shards(tmp_path)
