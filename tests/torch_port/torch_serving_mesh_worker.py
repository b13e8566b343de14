"""The body of the port's tensor-parallel serving tests, run in each process
of a 2-process gloo world by ``accelerate-tpu-torch launch
--use_cpu_emulation``:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes 2 torch_serving_mesh_worker.py MODE OUT_DIR

Both processes build the same engines in the same order; process 0 leads
every slice (submits, reads streams) and process 1 follows. MODE is
``engine`` (single-slice engines at tp 2 beside their tp 1 twins: greedy,
EOS, sampled, async against sync, adapters, int8 KV and weights, draft and
lookup speculation, K/V bytes, the head_dim split, prefix blocks, captures
and the construction errors) or ``fleet`` (``ReplicaSet.from_mesh`` with 2
slices x tp 2: a cross-slice prefix hit, a failover between slices, a
restart; per-slice adapter banks; a follower's failure; the prepared-model
routing; then a second fleet under a ``FleetSupervisor`` whose follower
fails inside a step). Inputs come from ``OUT_DIR/mesh_in.npz`` (the tiny Llama's
weights, its ``num_key_value_heads=1`` twin's, an adapter); process 0
writes ``OUT_DIR/<mode>.json``. Every engine records its ticks, and the
followers' ticks are held to the leader's at the end.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from accelerate_tpu_torch import PartialState
from accelerate_tpu_torch.adapters import AdapterBank, LoRAConfig
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.serving import (
    ChaosSchedule,
    FleetSupervisor,
    PrefixCache,
    ReplicaSet,
    ReplicaState,
    ServingEngine,
)
from accelerate_tpu_torch.serving.mesh_exec import (
    SliceExec,
    SliceFollowerError,
    SlicePlan,
    shard_for_serving,
)

EOS = 7
PROMPTS = [np.array([[3, 5, 7, 11, 2]], np.int32), np.array([[1, 4, 9]], np.int32),
           np.array([[8, 6, 4, 2, 10, 12, 14]], np.int32), np.array([[42]], np.int32)]
LONG = np.arange(1, 20, dtype=np.int32)[None]
BASE = dict(device="cpu", cache_dtype=torch.float32, max_slots=3, max_len=64,
            eos_token_id=EOS, prefill_chunk=8)
CPU2 = [torch.device("cpu")] * 2

ENGINES = []   # every engine built, for the tick check


def model_from(inputs, prefix: str, **overrides) -> LlamaForCausalLM:
    model = LlamaForCausalLM(LlamaConfig.tiny(**overrides), device="cpu")
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith(prefix)})
    return model.eval()


def adapter_from(inputs) -> dict:
    out = {}
    for k in inputs.files:
        if k.startswith("adapter."):
            name, leaf = k[len("adapter."):].rsplit(".", 1)
            out.setdefault(name, {})[leaf] = torch.from_numpy(inputs[k])
    return out


def engine(model, tp, **kw) -> ServingEngine:
    e = ServingEngine(model, tp=tp, **{**BASE, **kw})
    ENGINES.append(e)
    return e


def streams(e, prompts, n, stagger=0.0, **kw):
    """Each prompt's stream (process 0; None elsewhere)."""
    if not e.leader:
        return None
    reqs = []
    for p in prompts:
        reqs.append(e.submit(p, max_new_tokens=n, **kw) if stagger else
                    e.submit(p, max_new_tokens=n, block=True, **kw))
        if stagger:
            time.sleep(stagger)
        else:
            reqs[-1].result(120)
    return [np.asarray(r.result(120)).tolist() for r in reqs]


def close(*engines):
    for e in engines:
        e.shutdown(drain=False)


def expect(kind, fn):
    """The error ``fn`` raises (the same on every process), as a string."""
    try:
        fn()
    except kind as e:
        return f"{type(e).__name__}: {e}"
    return None


def run_engine(inputs, out: dict):
    model = model_from(inputs, "param.")
    # Greedy and EOS, the captures after warmup, the K/V bytes.
    e1, e2 = engine(model, 1), engine(model, 2)
    out["greedy_tp1"] = streams(e1, PROMPTS + [LONG], 16)
    out["greedy_tp2"] = streams(e2, PROMPTS + [LONG], 16)
    out["eos_tp1"] = streams(e1, PROMPTS, 24)
    out["eos_tp2"] = streams(e2, PROMPTS, 24)
    out["kv_bytes"] = [e1.kv_cache_per_chip_bytes(), e2.kv_cache_per_chip_bytes()]
    out["captures"] = [sorted(e.compile_watcher.counts()) for e in (e1, e2)]
    for e in (e1, e2):
        e.compile_watcher.reset()
    out["mixed"] = [streams(e, PROMPTS + [LONG, LONG], 8, stagger=0.002) for e in (e1, e2)]
    out["events_after_warmup"] = [e.compile_watcher.events for e in (e1, e2)]
    # Async against sync at tp 2.
    es = engine(model, 2, async_ticks=False)
    out["async"] = streams(e2, PROMPTS + [LONG], 16, stagger=0.005)
    out["sync"] = streams(es, PROMPTS + [LONG], 16, stagger=0.005)
    close(es)
    # Speculation: a draft model (replicated) and prompt lookup, against
    # the non-speculative tp 1 streams.
    out["spec_ref"] = streams(e1, PROMPTS, 24, stagger=0.01)
    for name, kw in (("draft", dict(draft_model=model)), ("lookup", dict(spec_lookup=2))):
        es = engine(model, 2, prefix_cache_mb=0.0, spec_tokens=4, **kw)
        out[name] = streams(es, PROMPTS, 24, stagger=0.01)
        out[name + "_spec_ticks"] = es.serving_metrics()["spec_ticks"] if es.leader else None
        close(es)
    close(e1, e2)

    # Sampled streams: tp 2 against the port's own tp 1.
    for tp in (1, 2):
        e = engine(model, tp, max_slots=2, do_sample=True, temperature=0.9, top_k=40)
        out[f"sampled_tp{tp}"] = (None if not e.leader else [
            np.asarray(e.submit(p, max_new_tokens=12, seed=123 + i, block=True).result(120))
            .tolist() for i, p in enumerate(PROMPTS)])
        close(e)

    # Adapters (a nonzero b) on a bank, the adapter's and the base's streams.
    adapter = adapter_from(inputs)
    for tp in (1, 2):
        bank = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
        e = engine(model, tp, max_slots=2, adapters=bank)
        if e.leader:
            e.register_adapter("t1", adapter)
        out[f"adapter_tp{tp}"] = streams(e, PROMPTS[:1], 12, adapter="t1", ignore_eos=True)
        out[f"adapter_base_tp{tp}"] = streams(e, PROMPTS[:1], 12, ignore_eos=True)
        close(e)

    # int8 KV pages (the page amax a MAX over the slice) and int8 weights.
    for name, kw in (("int8_kv", dict(kv_dtype="int8")), ("int8_w", dict(weights_dtype="int8"))):
        e = engine(model, 2, **kw)
        out[name] = streams(e, PROMPTS + [LONG], 16)
        out[name + "_kv_bytes"] = e.kv_cache_per_chip_bytes()
        close(e)

    # K/V heads that do not split: head_dim does.
    single = model_from(inputs, "single.", num_key_value_heads=1)
    e1, e2 = engine(single, 1), engine(single, 2)
    out["hd_kv_bytes"] = [e1.kv_cache_per_chip_bytes(), e2.kv_cache_per_chip_bytes()]
    out["hd_axis"] = e2._kv_axis
    out["hd_tp2"] = streams(e2, PROMPTS + [LONG], 16)
    out["hd_tp1"] = streams(e1, PROMPTS + [LONG], 16)
    close(e1, e2)

    # Prefix blocks: a private paged cache aliases page ids; a shared cache
    # keeps whole blocks on the host; both restore a repeat bit-exactly.
    e = engine(model, 2, max_slots=2)
    out["private"] = [streams(e, [LONG], 10)[0] if e.leader else None for _ in range(2)]
    if e.leader:
        out["private_leaves"] = sorted({type(x).__name__ for block, _ in
                                        e.prefix_cache._entries.values() for x in block})
        m = e.serving_metrics()
        out["private_hits"] = [m["prefix_cache_hit_chunks"], m["prefix_alias_chunks"]]
    close(e)
    shared = PrefixCache(4 * 1024 * 1024)
    e = engine(model, 2, max_slots=2, prefix_cache=shared)
    out["shared"] = [streams(e, [LONG], 10)[0] if e.leader else None for _ in range(2)]
    if e.leader:
        out["shared_blocks"] = sorted({(str(b.device), tuple(b.shape)) for b, _ in
                                       shared._entries.values()})
        out["shared_hits"] = e.serving_metrics()["prefix_cache_hit_chunks"]
    close(e)

    # A slice's mesh; the weight bridge cuts a whole state dict into this
    # process's shard, which serves that slice as it is.
    plan = SlicePlan.plan(2, num_slices=1, devices=CPU2)
    mesh = plan.build_mesh(0)
    out["mesh"] = [mesh.shape["tp"], mesh.coords["tp"], [str(d) for d in mesh.torch_devices]]
    state = {k[len("param."):]: torch.from_numpy(inputs[k]) for k in inputs.files
             if k.startswith("param.")}
    shard = shard_for_serving(state, SliceExec(mesh), config=LlamaConfig.tiny())
    out["bridge_widths"] = [shard.model.layers[0].self_attn.q_proj.weight.shape[0],
                            shard.model.layers[0].mlp.down_proj.weight.shape[1],
                            shard.model.embed_tokens.weight.shape[1],
                            shard.lm_head.weight.shape[0]]
    e = engine(shard, None, mesh=mesh)
    out["bridge"] = streams(e, PROMPTS + [LONG], 16)
    close(e)
    out["monolithic"] = expect(NotImplementedError,
                               lambda: ServingEngine(model, tp=2, **{**BASE,
                                                                     "prefill_chunk": None}))
    out["conflict"] = expect(ValueError, lambda: ServingEngine(model, tp=4, mesh=mesh, **BASE))
    out["devices_alone"] = expect(ValueError,
                                  lambda: ServingEngine(model, devices=CPU2, **BASE))


def run_fleet(inputs, out: dict):
    model = model_from(inputs, "param.")
    fleet = ReplicaSet.from_mesh(model, tp=2, num_slices=2, **{**BASE, "max_slots": 2})
    initial = [fleet.engine(i) for i in range(2)]
    ENGINES.extend(initial)
    out["fleet_plan"] = [len(fleet), fleet.slice_plan.tp, fleet.engine(0).tp,
                         fleet.engine(1).tp, fleet.engine(0).mesh.index,
                         fleet.engine(1).mesh.index, fleet.leader]
    if fleet.leader:
        e0, e1 = fleet.engine(0), fleet.engine(1)
        out["fleet_shared_cache"] = e0.prefix_cache is e1.prefix_cache
        a = np.asarray(e0.submit(LONG, max_new_tokens=10, block=True).result(120))
        b = np.asarray(e1.submit(LONG, max_new_tokens=10, block=True).result(120))
        out["cross"] = [a.tolist(), b.tolist(), e1.serving_metrics()["prefix_cache_hit_chunks"]]
        r = fleet.submit(LONG, max_new_tokens=40, ignore_eos=True)
        deadline = time.monotonic() + 60
        while len(r.tokens) < 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        victim = r.replica_trail[0]
        fleet.kill_replica(victim)
        assert r.wait(timeout=120)
        out["failover"] = [np.asarray(r.tokens).tolist(), r.failovers, r.replica_trail]
        # The dead slice rebuilt on its devices: the prefix it inserted is
        # still a hit.
        new = fleet.restart_replica(victim)
        ENGINES.append(new)
        c = np.asarray(new.submit(LONG, max_new_tokens=10, block=True).result(120))
        out["restart"] = [c.tolist(), new.serving_metrics()["prefix_cache_hit_chunks"],
                          new.mesh.index == victim]
    fleet.shutdown()
    if not fleet.leader:  # the follower of the slice the leader rebuilt
        ENGINES.extend(fleet.engine(i) for i in range(2) if fleet.engine(i) is not initial[i])
    run_mid_step(model, out)

    # One bank cannot serve two slices.
    plan = SlicePlan.plan(2, num_slices=2, devices=CPU2 * 2)
    m0, m1 = plan.build_mesh(0), plan.build_mesh(1)
    shared = AdapterBank(model, config=LoRAConfig(rank=4), max_adapters=3)
    kw = {**BASE, "max_slots": 1, "max_len": 32}
    e0 = engine(model, None, adapters=shared, mesh=m0, **kw)
    out["own_bank"] = expect(ValueError, lambda: ServingEngine(model, adapters=shared, mesh=m1,
                                                               **kw))
    close(e0)

    # A follower that fails fails its leader's engine at the next step.
    chaos = ChaosSchedule().kill(at_tick=3) if dist.get_rank() == 1 else None
    e = ServingEngine(model, tp=2, chaos=chaos, **BASE)
    if e.leader:
        r = e.submit(LONG, max_new_tokens=30, ignore_eos=True)
        r.wait(120)
        out["follower_failure"] = [r.status.value, isinstance(e.error, SliceFollowerError),
                                   len(r.tokens)]
    try:
        e.shutdown(drain=False)
        died = None
    except RuntimeError as err:
        died = repr(err.__cause__)
    gathered = [None, None]
    dist.all_gather_object(gathered, died)
    out["follower_died"] = gathered[1]

    # A model prepared under a tp-only mesh serves sliced; one sharded over
    # another axis raises; unsharded parameters on a dp mesh keep one device.
    from accelerate_tpu_torch import (
        Accelerator,
        AcceleratorState,
        FullyShardedDataParallelPlugin,
        GradientState,
        TensorParallelPlugin,
    )

    def fresh():
        return model_from(inputs, "param.")

    acc = Accelerator(cpu=True, tp_plugin=TensorParallelPlugin(tp_size=2))
    e = ServingEngine(acc.prepare(fresh()), accelerator=acc, **BASE)
    out["prepared_tp"] = [e.tp, e._exec is not None, streams(e, PROMPTS[:1], 8)]
    close(e)
    AcceleratorState._reset_state(reset_partial_state=False)
    GradientState._reset_state()
    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(
        min_weight_size_to_shard=16))
    prepared = acc.prepare(fresh())
    out["prepared_fsdp"] = expect(ValueError, lambda: ServingEngine(
        prepared, accelerator=acc, autostart=False, **BASE))
    AcceleratorState._reset_state(reset_partial_state=False)
    GradientState._reset_state()
    acc = Accelerator(cpu=True)
    e = ServingEngine(fresh(), accelerator=acc, autostart=False, **BASE)
    out["prepared_dp"] = [e.tp, e._exec is None]


#: The supervisor's timeouts in the mid-step case: the failover must come
#: within their sum.
HANG_TIMEOUT_S, KILL_GRACE_S = 5.0, 2.0


def run_mid_step(model, out: dict):
    """A fleet of 2 slices x tp 2 under a ``FleetSupervisor``; the leader
    names a victim slice through the store and the follower's next
    all-reduce on that slice's device group raises, inside a step, while
    the leader waits in the same collective. The leader's engine must die
    of it at once (a ``SliceFollowerError``), the stream fail over
    token-exactly, and the supervisor rebuild the slice on its devices
    with a fresh device group."""
    store = dist.distributed_c10d._get_default_store()
    fleet = ReplicaSet.from_mesh(model, tp=2, num_slices=2, **{**BASE, "max_slots": 2})
    if not fleet.leader:
        for i in range(2):
            group = fleet._slice_meshes[i].group("tp")

            def failing(t, op="sum", _key=f"mid_step/{i}", _real=group.all_reduce):
                if store.check([_key]):
                    store.delete_key(_key)
                    raise RuntimeError("scripted failure inside a step")
                return _real(t, op)

            group.all_reduce = failing
        fleet.shutdown()
        return
    with FleetSupervisor(fleet, hang_timeout_s=HANG_TIMEOUT_S, kill_grace_s=KILL_GRACE_S,
                         poll_interval_s=0.02, restart_backoff_s=0.05):
        r = fleet.submit(LONG, max_new_tokens=40, ignore_eos=True)
        deadline = time.monotonic() + 60
        while len(r.tokens) < 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        victim = r.replica_trail[0]
        old = fleet.engine(victim)
        start = time.monotonic()
        store.set(f"mid_step/{victim}", "1")
        while r.failovers < 1 and not r.done and time.monotonic() - start < 120:
            time.sleep(0.002)
        failed_over_s = time.monotonic() - start
        assert r.wait(timeout=120)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                fleet.engine(victim) is old
                or fleet.replica_states()[victim] is not ReplicaState.HEALTHY):
            time.sleep(0.01)
        new = fleet.engine(victim)
        c = np.asarray(new.submit(LONG, max_new_tokens=10, block=True).result(120))
        out["mid_step"] = {
            "tokens": np.asarray(r.tokens).tolist(), "failovers": r.failovers,
            "trail": r.replica_trail, "failed_over_s": failed_over_s,
            "limit_s": HANG_TIMEOUT_S + KILL_GRACE_S,
            "follower_error": isinstance(old.error, SliceFollowerError),
            "old_thread_done": old._thread is None or not old._thread.is_alive(),
            "restarted": new is not old, "same_mesh": new.mesh is old.mesh,
            "same_devices": list(map(str, new.mesh.torch_devices))
            == list(map(str, old.mesh.torch_devices)),
            "generation": new.mesh.generation, "after_restart": c.tolist()}
    fleet.shutdown()


def main():
    mode, out_dir = sys.argv[1], Path(sys.argv[2])
    PartialState()
    ServingEngine.record_ticks = True
    inputs = np.load(out_dir / "mesh_in.npz")
    out: dict = {}
    {"engine": run_engine, "fleet": run_fleet}[mode](inputs, out)
    # Every tick of every slice above tp 1, on both processes: the
    # follower's list may run past the leader's by the ticks a killed
    # leader launched and never read.
    ticks = [[t.tolist() for t in e.tick_log] for e in ENGINES if e.tp > 1]
    gathered = [None, None]
    dist.all_gather_object(gathered, ticks)
    if dist.get_rank() == 0:
        out["ticks"] = [[len(a), len(b), b[:len(a)] == a] for a, b in zip(*gathered)]
        (out_dir / f"{mode}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()
