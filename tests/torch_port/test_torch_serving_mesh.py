"""Tensor-parallel serving slices (``serving/mesh_exec.py``, the engine's
``tp=``/``mesh=``/``devices=``, ``ReplicaSet.from_mesh``, ``serve --tp``)
against the JAX package's, class by class as ``tests/test_serving_mesh.py``.

The JAX package drives a slice from one process over emulated devices
(conftest's 8); the port runs one process per tp index. Every tp 2 case
runs the port in a 2-process gloo world through ``accelerate-tpu-torch
launch --use_cpu_emulation`` (``torch_serving_mesh_worker.py`` in each
process: process 0 leads, process 1 follows) and the JAX engine at tp 2 on
the same numpy-seeded tiny Llama (4 heads, 2 K/V heads), while the world
runs. The tp 1 slice (what the card runs) and the policy functions run in
this process.

Tolerances: greedy streams (plain, EOS, adapters, draft and lookup
speculation, int8 KV pages, int8 weights, the failover) are held
token-exact at an f32 cache; sampled streams to the port's own tp 1
(draws keyed by seed and position, not threefry); per-device K/V bytes
exactly to the JAX engine's; specs string for string; every follower's
tick outputs bit-equal to its leader's.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch
from torch_fleet_common import jax_engine
from torch_mesh_common import REPO, TIMEOUT
from torch_serving_common import pair

from accelerate_tpu.adapters import AdapterBank as JaxAdapterBank
from accelerate_tpu.adapters import LoRAConfig as JaxLoRAConfig
from accelerate_tpu.adapters import init_lora_params as jax_init_lora
from accelerate_tpu.adapters.lora import _get_path as jax_get_path
from accelerate_tpu.adapters.lora import adapter_module_paths as jax_module_paths
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.serving.mesh_exec import SliceExec as JaxSliceExec
from accelerate_tpu.serving.mesh_exec import SlicePlan as JaxSlicePlan
from accelerate_tpu_torch.adapters import AdapterBank, LoRAConfig, quantize_base_weights
from accelerate_tpu_torch.adapters.quantize import shardings_for_quantized
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.parallel.mesh import Mesh, MeshConfig
from accelerate_tpu_torch.parallel.sharding import _is_kernel, reference_path, swap_spec
from accelerate_tpu_torch.serving import PrefixCache, ReplicaSet, ServingEngine
from accelerate_tpu_torch.serving.mesh_exec import SliceExec, SlicePlan, validate_serving_mesh
from accelerate_tpu_torch.utils.convert import adapter_from_flax, state_dict_from_flax

WORKER = REPO / "tests" / "torch_port" / "torch_serving_mesh_worker.py"
EOS = 7
PROMPTS = [np.array([[3, 5, 7, 11, 2]], np.int32), np.array([[1, 4, 9]], np.int32),
           np.array([[8, 6, 4, 2, 10, 12, 14]], np.int32), np.array([[42]], np.int32)]
LONG = np.arange(1, 20, dtype=np.int32)[None]
BASE = dict(max_slots=3, max_len=64, eos_token_id=EOS, prefill_chunk=8)
CARDS = [torch.device("cuda", i) for i in range(8)]  # names only: no card is touched


def _trim(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_paths(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


def _offline(module, params, prompt, n) -> np.ndarray:
    out = jax_generate(module, params, prompt, max_new_tokens=n, eos_token_id=EOS,
                       cache_dtype=jax.numpy.float32)
    return np.asarray(out)[0, prompt.shape[1]:]


def _matches_offline(got, ref):
    got = np.asarray(got)
    if not np.array_equal(got, ref[:len(got)]):
        return False
    return len(got) == len(ref) or (got[-1] == EOS and np.all(ref[len(got):] == EOS))


def _jax_adapter(params, seed=1, rank=4):
    """A JAX adapter with a nonzero ``b`` (a zero delta makes parity vacuous)."""
    ad = jax_init_lora(jax.random.PRNGKey(seed), params, JaxLoRAConfig(rank=rank))
    for i, dotted in enumerate(jax_module_paths(ad)):
        mod = jax_get_path(ad, dotted)
        mod["b"] = jax.random.normal(jax.random.PRNGKey(100 * seed + i), mod["b"].shape) * 0.1
    return ad


@pytest.fixture(scope="module")
def tiny():
    return pair(seed=0)


@pytest.fixture(scope="module")
def tp2_exec():
    """The policy half of a tp 2 slice (no process group needed)."""
    return SliceExec(Mesh({"tp": 2}, [0, 1]))


@pytest.fixture(scope="module")
def jax_exec():
    return JaxSliceExec(JaxSlicePlan.plan(2, num_slices=1).build_mesh(0))


# ---------------------------------------------------------------------------
# SlicePlan, validate_serving_mesh, heads_axis
# ---------------------------------------------------------------------------

class TestSlicePlan:
    def test_carves_disjoint_slices(self):
        plan = SlicePlan.plan(2, devices=CARDS)
        assert plan.tp == 2 and len(plan) == 4
        seen = set()
        for s in plan.slices:
            assert len(s) == 2
            ids = {d.index for d in s}
            assert not ids & seen
            seen |= ids
        assert plan.slices[1] == tuple(CARDS[2:4])  # devices[s*tp:(s+1)*tp]

    def test_num_slices_and_mesh(self):
        plan = SlicePlan.plan(2, num_slices=2, devices=CARDS)
        assert len(plan) == 2
        one = SlicePlan.plan(1, num_slices=2, devices=["cpu", "cpu"])
        mesh = one.build_mesh(1)
        assert mesh.shape["tp"] == 1 and mesh.index == 1 and mesh.channel is None
        assert mesh.torch_devices == one.slices[1]
        assert validate_serving_mesh(mesh) is mesh

    def test_plan_validation(self):
        with pytest.raises(ValueError, match="tp"):
            SlicePlan.plan(0, devices=CARDS)
        with pytest.raises(ValueError, match="devices"):
            SlicePlan.plan(2, num_slices=8, devices=CARDS)
        with pytest.raises(ValueError, match="devices"):
            SlicePlan.plan(9, devices=CARDS)

    def test_validate_serving_mesh_rejects_data_axes(self):
        dp_mesh = MeshConfig().build(devices=[0, 1, 2, 3])
        with pytest.raises(ValueError, match="from_mesh"):
            validate_serving_mesh(dp_mesh)

    def test_heads_axis_selection_is_the_jax_choice(self, tp2_exec, jax_exec):
        shapes = [((1, 64, 2, 16), 1), ((1, 64, 3, 16), 1), ((1, 64, 3, 5), 1),
                  ((1, 64, 1, 16), 1), ((64, 4, 8), 0)]
        for shape, length_axis in shapes:
            assert (tp2_exec.heads_axis(shape, length_axis)
                    == jax_exec.heads_axis(shape, length_axis)), shape
        assert tp2_exec.heads_axis((1, 64, 2, 16), 1) == 2
        assert tp2_exec.heads_axis((1, 64, 3, 16), 1) == 3
        assert tp2_exec.heads_axis((1, 64, 3, 5), 1) is None


# ---------------------------------------------------------------------------
# the shardings, string for string with the JAX package's
# ---------------------------------------------------------------------------

class TestShardings:
    def test_param_shardings_are_the_jax_specs(self, tiny, tp2_exec, jax_exec):
        _, params, model = tiny
        want = {p: _trim(sh.spec) for p, sh in _jax_paths(jax_exec.param_shardings(params)).items()}
        got = tp2_exec.param_shardings(model)
        assert len(got) == len(want)
        for name, spec in got.items():
            p = model.get_parameter(name)
            ref = _trim(swap_spec(spec, p.dim(), _is_kernel(model, name, p.dim())))
            assert ref == want[reference_path(model, name)], name
        # Column, row, embedding and head, as the Megatron rules split them.
        assert tuple(got["model.layers.0.self_attn.q_proj.weight"]) == ("tp",)
        assert tuple(got["model.layers.0.mlp.down_proj.weight"]) == (None, "tp")
        assert tuple(got["model.embed_tokens.weight"]) == (None, "tp")
        assert tuple(got["lm_head.weight"]) == ("tp",)

    def test_bank_shardings_are_the_jax_specs(self, tiny, tp2_exec, jax_exec):
        _, params, model = tiny
        jax_bank = JaxAdapterBank(params, config=JaxLoRAConfig(rank=4), max_adapters=3)
        want = {p: _trim(sh.spec) for p, sh in _jax_paths(jax_exec.bank_shardings(jax_bank)).items()}
        got = tp2_exec.bank_shardings(AdapterBank(model, config=LoRAConfig(rank=4),
                                                  max_adapters=3))
        assert len(want) == 3 * len(got)
        for path, leaves in got.items():
            jax_path = path.replace(".layers.", ".layers_").replace(".", "/")
            for leaf, spec in leaves.items():
                assert _trim(spec) == want[f"{jax_path}/{leaf}"], (path, leaf)

    def test_shardings_for_quantized_are_the_jax_specs(self, tiny, tp2_exec, jax_exec):
        from accelerate_tpu.adapters.quantize import quantize_base_weights as jax_quantize
        from accelerate_tpu.adapters.quantize import shardings_for_quantized as jax_shardings
        from accelerate_tpu.utils.quantization import QuantizedTensor

        _, params, model = tiny
        quantized = (lambda x: isinstance(x, QuantizedTensor))
        want = _jax_paths(jax_shardings(jax_exec, jax_quantize(params)), is_leaf=quantized)
        q8 = quantize_base_weights(model)
        got = shardings_for_quantized(tp2_exec, q8)
        checked = 0
        for name, spec in got.items():
            if not name.endswith((".weight_q", ".weight_scale")):
                continue
            base = name.rsplit(".", 1)[0]
            jax_leaf = want[reference_path(model, base + ".weight")]
            ref = jax_leaf.q if name.endswith("_q") else jax_leaf.scale
            assert _trim(swap_spec(spec, 2, True)) == _trim(ref.spec), name
            checked += 1
        assert checked == 2 * 7 * model.config.num_hidden_layers
        # Row-parallel scales stay whole; column-parallel ones split.
        assert tuple(got["model.layers.0.mlp.down_proj.weight_scale"]) == ()
        assert tuple(got["model.layers.0.mlp.up_proj.weight_scale"]) == ("tp",)

    def test_state_and_block_shardings_split_the_heads_axis(self, tp2_exec):
        kv = [{"k": torch.zeros(5, 2, 8, 16), "v": torch.zeros(5, 2, 8, 16)}]
        state = {"pool": kv, "pos": torch.zeros(3), "pscale": torch.zeros(2, 5)}
        specs = tp2_exec.state_shardings(state, [(1, 64, 2, 16)] * 2, [1, 1])
        assert tuple(specs["pool"][0]["k"]) == (None, "tp")
        assert tuple(specs["pos"]) == () and tuple(specs["pscale"]) == ()
        assert tuple(tp2_exec.block_shardings([(1, 64, 2, 16)], [1])) == (None, None, "tp")
        assert tuple(tp2_exec.block_shardings([(1, 64, 1, 16)], [1])) == (None,) * 4 + ("tp",)
        placed = tp2_exec.place(kv, specs["pool"])
        assert tuple(placed[0]["k"].shape) == (5, 1, 8, 16)
        assert tp2_exec.per_chip_bytes(placed) == 2 * 5 * 8 * 16 * 4


# ---------------------------------------------------------------------------
# the tp 1 slice (the card's path) in this process
# ---------------------------------------------------------------------------

def _port(model, **kw):
    return ServingEngine(model, device="cpu", cache_dtype=torch.float32, **{**BASE, **kw})


class TestOneDeviceSlice:
    def test_tp1_streams_equal_generate_and_the_plain_engine(self, tiny):
        module, params, model = tiny
        plain, sliced = _port(model), _port(model, tp=1)
        try:
            assert sliced.tp == 1 and sliced._exec is not None and plain._exec is None
            for p in PROMPTS + [LONG]:
                a = np.asarray(plain.submit(p, max_new_tokens=16, block=True).result(60))
                b = np.asarray(sliced.submit(p, max_new_tokens=16, block=True).result(60))
                assert np.array_equal(a, b), (p, a, b)
                assert _matches_offline(b, _offline(module, params, p, 16)), (p, b)
            assert sliced.kv_cache_per_chip_bytes() == plain.kv_cache_per_chip_bytes()
            assert not sliced.compile_watcher.events
        finally:
            plain.shutdown(drain=False)
            sliced.shutdown(drain=False)

    def test_tp1_shared_cache_keeps_host_blocks(self, tiny):
        _, _, model = tiny
        shared = PrefixCache(4 << 20)
        e = _port(model, tp=1, prefix_cache=shared)
        try:
            a = np.asarray(e.submit(LONG, max_new_tokens=10, block=True).result(60))
            assert len(shared) >= 2
            for block, _ in shared._entries.values():
                assert block.device.type == "cpu" and tuple(block.shape) == e._block_shape
            b = np.asarray(e.submit(LONG, max_new_tokens=10, block=True).result(60))
            assert np.array_equal(a, b)
            assert e.serving_metrics()["prefix_cache_hit_chunks"] >= 2
        finally:
            e.shutdown(drain=False)

    def test_construction_refusals(self, tiny):
        _, _, model = tiny
        with pytest.raises(NotImplementedError, match="single-chip"):
            _port(model, tp=1, prefill_chunk=None, autostart=False)
        mesh = SlicePlan.plan(1, num_slices=1, devices=["cpu"]).build_mesh(0)
        with pytest.raises(ValueError, match="tp"):
            _port(model, tp=2, mesh=mesh, autostart=False)
        with pytest.raises(ValueError, match="devices"):
            _port(model, devices=["cpu"], autostart=False)

    def test_weight_bridge_from_flax_params(self, tiny):
        """Flax params cut for a tp 1 slice serve the model's streams; the
        shard serves its own slice as it is and refuses another's."""
        from accelerate_tpu_torch.serving.mesh_exec import shard_for_serving

        _, params, model = tiny
        mesh = SlicePlan.plan(1, devices=["cpu"]).build_mesh(0)
        exec_ = SliceExec(mesh)
        shard = shard_for_serving(jax.tree_util.tree_map(np.asarray, params), exec_,
                                  config=model.config)
        assert shard_for_serving(shard, exec_) is shard
        with pytest.raises(ValueError, match="cannot serve"):
            shard_for_serving(shard, exec_, weights_dtype="int8")
        for name, p in model.state_dict().items():
            assert torch.equal(shard.state_dict()[name], p), name
        a, b = _port(model), _port(shard, mesh=mesh)
        try:
            for p in PROMPTS:
                assert np.array_equal(
                    np.asarray(a.submit(p, max_new_tokens=12, block=True).result(60)),
                    np.asarray(b.submit(p, max_new_tokens=12, block=True).result(60)))
        finally:
            a.shutdown(drain=False)
            b.shutdown(drain=False)

    def test_per_slice_adapter_banks_required(self, tiny):
        _, _, model = tiny
        plan = SlicePlan.plan(1, num_slices=2, devices=["cpu", "cpu"])
        shared = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
        e0 = _port(model, adapters=shared, mesh=plan.build_mesh(0), max_slots=1, max_len=32)
        try:
            with pytest.raises(ValueError, match="OWN bank"):
                _port(model, adapters=shared, mesh=plan.build_mesh(1), max_slots=1, max_len=32)
        finally:
            e0.shutdown(drain=False)

    def test_tp1_fleet_failover_restart_keeps_prefix_hits(self, tiny):
        module, params, model = tiny
        fleet = ReplicaSet.from_mesh(model, tp=1, num_slices=2, device="cpu",
                                     cache_dtype=torch.float32, **{**BASE, "max_slots": 2})
        try:
            assert len(fleet) == 2 and fleet.slice_plan.tp == 1 and fleet.leader
            assert fleet.engine(0).prefix_cache is fleet.engine(1).prefix_cache
            a = np.asarray(fleet.engine(0).submit(LONG, max_new_tokens=10,
                                                  block=True).result(60))
            r = fleet.submit(LONG, max_new_tokens=40, ignore_eos=True)
            deadline = time.monotonic() + 60
            while len(r.tokens) < 4 and time.monotonic() < deadline:
                time.sleep(0.002)
            victim = r.replica_trail[0]
            fleet.kill_replica(victim)
            assert r.wait(timeout=60)
            full = _offline(module, params, LONG, 40)
            got = np.asarray(r.tokens)
            assert np.array_equal(got, full[:len(got)]) and len(got) == 40
            assert r.failovers == 1 and r.replica_trail == [victim, 1 - victim]
            new = fleet.restart_replica(victim)
            assert new.mesh is fleet.engine(victim).mesh and new.mesh.index == victim
            b = np.asarray(new.submit(LONG, max_new_tokens=10, block=True).result(60))
            assert np.array_equal(a, b)
            assert new.serving_metrics()["prefix_cache_hit_chunks"] >= 2, (
                "the rebuilt slice recomputed a prefix its predecessor cached")
        finally:
            fleet.shutdown()


# ---------------------------------------------------------------------------
# tp 2 over a 2-process gloo world against the JAX engine at tp 2
# ---------------------------------------------------------------------------

def _write_inputs(tmp_path, params, single_params):
    cfg, single_cfg = LlamaConfig.tiny(), LlamaConfig.tiny(num_key_value_heads=1)
    arrays = {f"param.{k}": v.numpy() for k, v in state_dict_from_flax(params, cfg).items()}
    arrays.update({f"single.{k}": v.numpy()
                   for k, v in state_dict_from_flax(single_params, single_cfg).items()})
    adapter = adapter_from_flax(jax.tree_util.tree_map(np.asarray, _jax_adapter(params)))
    for name, mod in adapter.items():
        for leaf, t in mod.items():
            arrays[f"adapter.{name}.{leaf}"] = t.numpy()
    np.savez(tmp_path / "mesh_in.npz", **arrays)


def _start_world(tmp_path, mode):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
           "--use_cpu_emulation", "--num_processes", "2", str(WORKER), mode, str(tmp_path)]
    return subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def _finish_world(proc, tmp_path, mode) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"timed out after {TIMEOUT} s:\n{out[-3000:]}\n{err[-3000:]}")
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return json.loads((tmp_path / f"{mode}.json").read_text())


def _jax_streams(engine, prompts, n, **kw):
    return [np.asarray(engine.submit(p, max_new_tokens=n, block=True, **kw).result(120))
            for p in prompts]


def test_tp2_slice_engines_follow_the_jax_engine(tmp_path, tiny):
    module, params, _ = tiny
    single_module, single_params, _ = pair(seed=0, num_key_value_heads=1)
    _write_inputs(tmp_path, params, single_params)
    proc = _start_world(tmp_path, "engine")
    # The JAX package at tp 2 on emulated devices while the world runs.
    ref = {}
    kw = dict(tp=2, **BASE)
    e = jax_engine(module, params, **kw)
    try:
        ref["greedy"] = _jax_streams(e, PROMPTS + [LONG], 16)
        ref["eos"] = _jax_streams(e, PROMPTS, 24)
        ref["kv_bytes"] = e.kv_cache_per_chip_bytes()
    finally:
        e.shutdown(drain=False)
    bank = JaxAdapterBank(params, config=JaxLoRAConfig(rank=4), max_adapters=3)
    e = jax_engine(module, params, adapters=bank, **{**kw, "max_slots": 2})
    try:
        e.register_adapter("t1", _jax_adapter(params))
        ref["adapter"] = _jax_streams(e, PROMPTS[:1], 12, adapter="t1", ignore_eos=True)
        ref["adapter_base"] = _jax_streams(e, PROMPTS[:1], 12, ignore_eos=True)
    finally:
        e.shutdown(drain=False)
    for name, extra in (("int8_kv", dict(kv_dtype="int8")), ("int8_w", dict(weights_dtype="int8"))):
        e = jax_engine(module, params, **kw, **extra)
        try:
            ref[name] = _jax_streams(e, PROMPTS + [LONG], 16)
            ref[name + "_kv_bytes"] = e.kv_cache_per_chip_bytes()
        finally:
            e.shutdown(drain=False)
    e = jax_engine(single_module, single_params, **kw)
    try:
        ref["hd_kv_bytes"] = e.kv_cache_per_chip_bytes()
    finally:
        e.shutdown(drain=False)
    offline = [_offline(module, params, p, 24) for p in PROMPTS + [LONG]]
    got = _finish_world(proc, tmp_path, "engine")

    def same(a, b, what):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (what, x, y)

    # Greedy and EOS: token-exact with JAX tp 2, the port's tp 1 and generate.
    same(got["greedy_tp2"], ref["greedy"], "greedy vs JAX tp 2")
    same(got["greedy_tp2"], got["greedy_tp1"], "greedy vs tp 1")
    same(got["eos_tp2"], ref["eos"], "EOS vs JAX tp 2")
    same(got["eos_tp2"], got["eos_tp1"], "EOS vs tp 1")
    for stream, want in zip(got["eos_tp2"], offline):
        assert _matches_offline(stream, want), stream
    # Sampled: the port's own tp 1; async against sync.
    same(got["sampled_tp2"], got["sampled_tp1"], "sampled vs tp 1")
    same(got["async"], got["sync"], "async vs sync")
    # Adapters with a nonzero b: both streams equal JAX's, and differ.
    same(got["adapter_tp2"], ref["adapter"], "adapter vs JAX tp 2")
    same(got["adapter_base_tp2"], ref["adapter_base"], "base vs JAX tp 2")
    same(got["adapter_tp2"], got["adapter_tp1"], "adapter vs tp 1")
    assert got["adapter_tp2"] != got["adapter_base_tp2"], "adapter delta is zero"
    # Speculation, with a replicated draft model or prompt lookup: the
    # non-speculative tp 1 streams, which are JAX's greedy ones.
    for stream, want in zip(got["spec_ref"], offline):
        assert _matches_offline(stream, want), stream
    for name in ("draft", "lookup"):
        same(got[name], got["spec_ref"], f"{name} speculation vs tp 1")
        assert got[name + "_spec_ticks"] > 0
    # int8 KV pages (one amax over the whole logical page: a MAX over the
    # slice) and int8 weights, token-exact with JAX tp 2.
    same(got["int8_kv"], ref["int8_kv"], "int8 KV vs JAX tp 2")
    same(got["int8_w"], ref["int8_w"], "int8 weights vs JAX tp 2")
    # Per-device K/V bytes: halved against tp 1 and equal to JAX's, also
    # where one K/V head leaves head_dim to split.
    kv1, kv2 = got["kv_bytes"]
    assert kv1 > 0 and 2 * kv2 == kv1 and kv2 == ref["kv_bytes"]
    assert got["int8_kv_kv_bytes"] == ref["int8_kv_kv_bytes"]
    assert got["int8_w_kv_bytes"] == ref["int8_w_kv_bytes"]
    hd1, hd2 = got["hd_kv_bytes"]
    assert got["hd_axis"] == 3 and 2 * hd2 == hd1 and hd2 == ref["hd_kv_bytes"]
    same(got["hd_tp2"], got["hd_tp1"], "head_dim split vs tp 1")
    # Prefix blocks: page ids in a private cache, whole host blocks in a
    # shared one; a repeat restores bit-exactly.
    same(got["private"][1:], got["private"][:1], "private cache repeat")
    assert got["private_leaves"] == ["int"] and min(got["private_hits"]) >= 2
    same(got["shared"][1:], got["shared"][:1], "shared cache repeat")
    same(got["shared"][:1], got["private"][:1], "shared vs private cache")
    assert got["shared_blocks"] == [["cpu", [2, 2, 2, 8, 16]]] and got["shared_hits"] >= 2
    # The warm steps are tp 1's, and a mixed round adds none.
    assert got["captures"][0] == got["captures"][1]
    assert got["events_after_warmup"] == [[], []]
    same(got["mixed"][1], got["mixed"][0], "mixed round vs tp 1")
    # The slice's mesh; a shard cut from the whole state dict (column and
    # row halves, the table on hidden, the head on the vocabulary) serves
    # the same streams.
    assert got["mesh"] == [2, 0, ["cpu", "cpu"]]
    assert got["bridge_widths"] == [32, 64, 32, 128]
    same(got["bridge"], got["greedy_tp2"], "a bridged shard vs the engine's own cut")
    # What construction refuses, on both processes.
    assert "single-chip" in got["monolithic"]
    assert "tp=" in got["conflict"] and "devices=" in got["devices_alone"]
    # Every follower's ticks are its leader's.
    assert got["ticks"] and all(a == b and ok for a, b, ok in got["ticks"]), got["ticks"]


def test_tp2_fleet_of_slices_fails_over_token_exact(tmp_path, tiny):
    module, params, _ = tiny
    single_params = pair(seed=0, num_key_value_heads=1)[1]
    _write_inputs(tmp_path, params, single_params)
    proc = _start_world(tmp_path, "fleet")
    full = _offline(module, params, LONG, 40)
    short = _offline(module, params, LONG, 10)
    first = _offline(module, params, PROMPTS[0], 8)
    got = _finish_world(proc, tmp_path, "fleet")

    assert got["fleet_plan"] == [2, 2, 2, 2, 0, 1, True]
    assert got["fleet_shared_cache"]
    # One slice prefills, the other hits its host blocks.
    a, b, hits = got["cross"]
    assert a == b and _matches_offline(b, short) and hits >= 2
    # Killing a slice mid-stream: the survivor resumes token-exactly.
    tokens, failovers, trail = got["failover"]
    assert np.array_equal(tokens, full[:len(tokens)]) and len(tokens) == 40
    assert failovers == 1 and trail == [trail[0], 1 - trail[0]]
    # Rebuilt on its devices and groups, it hits what its predecessor cached.
    c, hits, same_slice = got["restart"]
    assert c == a and hits >= 2 and same_slice
    assert "OWN bank" in got["own_bank"]
    # A follower's failure fails its leader's engine and is not swallowed.
    status, follower_error, _ = got["follower_failure"]
    assert status == "failed" and follower_error
    assert "scripted kill" in got["follower_died"]
    # A follower failing inside a step: its leader is released at once (no
    # wait on the device group's timeout), the stream fails over
    # token-exactly within the supervisor's hang timeout plus its grace,
    # and the slice is rebuilt on its devices with a fresh device group.
    mid = got["mid_step"]
    assert np.array_equal(mid["tokens"], full[:len(mid["tokens"])]) and len(mid["tokens"]) == 40
    assert mid["failovers"] == 1 and mid["trail"] == [mid["trail"][0], 1 - mid["trail"][0]]
    assert mid["failed_over_s"] < mid["limit_s"], mid["failed_over_s"]
    assert mid["follower_error"] and mid["old_thread_done"]
    assert mid["restarted"] and mid["same_mesh"] and mid["same_devices"]
    assert mid["generation"] == 1 and _matches_offline(mid["after_restart"], short)
    # Prepared models: a tp-only mesh routes into the slice; params split
    # over fsdp raise; unsplit params on a dp mesh keep one device.
    tp, sliced, streams = got["prepared_tp"]
    assert tp == 2 and sliced and _matches_offline(streams[0], first)
    assert "Re-prepare" in got["prepared_fsdp"]
    assert got["prepared_dp"] == [1, True]
    assert got["ticks"] and all(b_len - a_len <= 2 and ok for a_len, b_len, ok in got["ticks"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_tp2_replicas2_over_http(tmp_path):
    """``serve --tp 2 --replicas 2 --device cpu`` in a 2-process group:
    process 0 answers HTTP, process 1 follows both slices; SIGTERM to
    process 0 drains the fleet and both exit 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1", ACCELERATE_TPU_USE_CPU="true",
               ACCELERATE_TPU_NUM_PROCESSES="2",
               ACCELERATE_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "serve",
           "--tp", "2", "--replicas", "2", "--device", "cpu", "--port", "0",
           "--prefill-chunk", "8", "--max-len", "64", "--max-slots", "2"]
    procs = []
    for rank in range(2):
        logf = open(tmp_path / f"serve_{rank}.log", "w")
        procs.append(subprocess.Popen(
            cmd, cwd=str(REPO), stdout=logf, stderr=subprocess.STDOUT, start_new_session=True,
            env=dict(env, ACCELERATE_TPU_PROCESS_ID=str(rank),
                     ACCELERATE_TPU_LOCAL_PROCESS_ID=str(rank))))
    try:
        url, deadline = None, time.monotonic() + TIMEOUT
        while url is None and time.monotonic() < deadline:
            for line in (tmp_path / "serve_0.log").read_text().splitlines():
                if line.startswith("serving on "):
                    url = line.split()[2]
            assert all(p.poll() is None for p in procs), (tmp_path / "serve_0.log").read_text()
            time.sleep(0.1)
        assert url is not None, "serve did not come up"
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                 generator=torch.Generator().manual_seed(0)).eval()
        from accelerate_tpu_torch.generation import generate

        for p in PROMPTS + [LONG]:
            body = json.dumps({"prompt": p[0].tolist(), "max_new_tokens": 8}).encode()
            req = urllib.request.Request(url + "/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                reply = json.loads(resp.read())
            want = generate(model, torch.from_numpy(p).long(), max_new_tokens=8)[0, p.shape[1]:]
            assert reply["tokens"] == want.tolist(), (p, reply)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
        healthy = [line for line in metrics.splitlines()
                   if line.startswith("accelerate_tpu_serving_replicas_healthy ")]
        assert healthy and float(healthy[0].split()[1]) == 2, healthy
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=TIMEOUT) == 0
        assert "following the leader's 2 slice(s) of tp=2" in (tmp_path / "serve_1.log").read_text()
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
