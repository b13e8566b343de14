"""The port's public surface against the JAX package's.

Walks every module that both packages have (the package roots included),
and fails on a public name, a keyword of a public function or class, a
public method of a shared class, or a base class of the package's own
(``KwargsHandler``) that the port's counterpart lacks. The allow-list holds
two kinds of entry, each with its reason: what ROADMAP item A9 still owes,
tagged with the item, and what only the JAX design has (the parameter
pytree and PRNG keys a JAX function takes, flax's module plumbing, meshes
of XLA shardings, the pytree helpers, the JAX and TPU probes). An entry
the port no longer needs fails too, so the list shrinks as names are
ported.
"""

import importlib
import inspect
import types
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[2]


def _modules(package: str) -> set:
    """The dotted suffixes of every module of ``package`` ("" the root)."""
    out = set()
    for path in (_ROOT / package).rglob("*.py"):
        parts = path.relative_to(_ROOT / package).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.add("".join(f".{p}" for p in parts))
    return out


#: Every module both packages have.
MODULES = sorted(_modules("accelerate_tpu") & _modules("accelerate_tpu_torch"))

TAGS = {"A9", "JAX-only"}
_PYTREE = "a JAX function takes the parameter pytree; a torch module holds its parameters"
_KEY = "a JAX PRNG key; the port's functions take a torch.Generator"
_ABSTRACT = "flax's abstract init over example inputs; a torch module is built on the meta device"

#: Reference names the port does not have, by their home in the reference.
MISSING_OK = {
    "accelerate_tpu.utils.dataclasses.JitConfig": ("JAX-only", "jax.jit options"),
    "accelerate_tpu.parallel.sharding.replicated_sharding": (
        "JAX-only", "a NamedSharding over a mesh; a replicated leaf's spec is PartitionSpec()"),
    "accelerate_tpu.parallel.sharding.zero_step_compile_cache_guard": (
        "JAX-only", "keeps ZeRO executables out of XLA's persistent compile cache"),
    "accelerate_tpu.parallel.host_offload.shardings_like": (
        "JAX-only", "NamedShardings with a memory kind; a tensor's place is its device"),
    **{f"accelerate_tpu.models.{name}.init_params": (
        "JAX-only", "flax's init of a parameter pytree; a torch module is built with its "
        "weights (a generator, or the meta device)")
       for name in ("llama.LlamaForCausalLM", "llama.PipelinedLlamaForCausalLM",
                    "mixtral.MixtralForCausalLM", "gpt2.GPT2LMHeadModel", "opt.OPTForCausalLM",
                    "gptj.GPTJForCausalLM", "gpt_neox.GPTNeoXForCausalLM", "phi.PhiForCausalLM",
                    "bloom.BloomForCausalLM", "bert.BertForSequenceClassification",
                    "simple.MLP", "t5.T5ForConditionalGeneration",
                    "vit.ViTForImageClassification")},
    "accelerate_tpu.models.resnet.ResNet.init_variables": (
        "JAX-only", "flax's init of the params and batch_stats collections; the torch module "
                    "holds its parameters and its running statistics as buffers"),
    "accelerate_tpu.accelerator.Accelerator.next_rng_key": ("JAX-only", "a JAX PRNG key"),
    "accelerate_tpu.adapters.lora.LoRATrainState.train_params": ("JAX-only", _PYTREE),
    "accelerate_tpu.optimizer.AcceleratedOptimizer.accumulate_grads": (
        "JAX-only", "sums a gradient pytree; torch accumulates into each parameter's .grad"),
    "accelerate_tpu.optimizer.AcceleratedOptimizer.init_state": (
        "JAX-only", "optax's state built under jit; a torch optimizer makes its state at its "
        "first step"),
    "accelerate_tpu.serving.engine.ServingEngine.decode_memory_analysis": (
        "JAX-only", "XLA's memory analysis of the compiled decode step"),
    **{f"accelerate_tpu.utils.quantization.QuantizedTensor.{name}": (
        "JAX-only", "a pytree helper") for name in ("tree_flatten", "tree_unflatten")},
    "accelerate_tpu.utils.random.PartialState": (
        "JAX-only", "the JAX module's lazy state accessor"),
    **{f"accelerate_tpu.test_utils.{name}": ("JAX-only", "a JAX, orbax or TPU test guard")
       for name in ("require_orbax", "require_tpu", "use_emulated_devices")},
    **{f"accelerate_tpu.test_utils.scripts.test_script.{name}": (
        "JAX-only", "the JAX script's checks by device addressability; the port's script "
        "holds one check_state and one check_training against a one-process run")
       for name in ("check_state_and_mesh", "check_training_convergence_multiprocess",
                    "check_training_parity")},
    **{f"accelerate_tpu.ops.quant.Fp8Dense.{name}": (
        "JAX-only", "a flax initializer; the port's weights come from the model's init, a "
        "generator or a loaded state dict") for name in ("kernel_init", "bias_init")},
    "accelerate_tpu.ops.quant.overwrite_with_cotangent": (
        "JAX-only", "an optax transformation that overwrites a leaf with its cotangent; the "
        "port's statistics are buffers that commit_fp8_meta overwrites at the update"),
    "accelerate_tpu.accelerator.Model": (
        "JAX-only", "a flax apply function and its parameter pytree; the port takes nn.Module"),
    "accelerate_tpu.utils.profiling.CompileWatcher": (
        "JAX-only", "watches XLA compiles; the port's counterpart is GraphCaptureWatcher"),
    "accelerate_tpu.utils.random.make_rng_key": ("JAX-only", "a JAX PRNG key"),
    "accelerate_tpu.serving.mesh_exec.SliceExec.jit": (
        "JAX-only", "jax.jit with a slice's shardings; the port's steps are fixed-shape "
        "functions captured as CUDA graphs (serving/graphs.py)"),
    "accelerate_tpu.utils.modeling.jnp_to_np_dtype": ("JAX-only", "jax.numpy dtypes"),
    "accelerate_tpu.checkpointing.flatten_params": ("JAX-only", "a pytree helper"),
    "accelerate_tpu.checkpointing.save_array_tree": ("JAX-only", "a pytree helper"),
    "accelerate_tpu.checkpointing.load_array_tree": ("JAX-only", "a pytree helper"),
    "accelerate_tpu.data_loader.suppress_exceptions": (
        "JAX-only", "the JAX prefetcher's teardown guard"),
    "accelerate_tpu.utils.operations.PartialState": (
        "JAX-only", "the JAX module's lazy state accessor; the port reads the state in _group"),
    "accelerate_tpu.commands.launch.gcloud_pod_launcher": ("JAX-only", "TPU pods over gcloud"),
    "accelerate_tpu.utils.versions.is_jax_version": ("JAX-only", "a JAX probe"),
    "accelerate_tpu.utils.versions.is_flax_version": ("JAX-only", "a JAX probe"),
    **{f"accelerate_tpu.utils.imports.{name}": ("JAX-only", "a JAX or TPU probe")
       for name in ("is_jax_available", "is_flax_available", "is_optax_available",
                    "is_orbax_available", "is_grain_available", "is_pallas_available",
                    "is_tpu_available")},
}

#: Reference keywords the port's function or class lacks:
#: (home of the reference object, keywords, tag, reason).
KEYWORDS_OK = [
    ("accelerate_tpu.accelerator.Accelerator", ("dynamo_backend", "jit_config"), "JAX-only",
     "how XLA compiles the steps"),
    ("accelerate_tpu.accelerator.AcceleratedModel", ("model", "mesh", "param_shardings",
                                                     "autocast_enabled"),
     "JAX-only", "built by prepare from a flax Model and its mesh shardings"),
    ("accelerate_tpu.optimizer.AcceleratedOptimizer", ("tx", "params", "param_shardings",
                                                       "mesh"),
     "JAX-only", "an optax transformation over the parameter pytree"),
    *[(f"accelerate_tpu.parallel.host_offload.{name}", ("mesh",), "JAX-only",
       "a leaf keeps its mesh sharding across memory kinds; a tensor moves to a device")
      for name in ("put_tree", "to_host", "to_device")],
    ("accelerate_tpu.ops.quant.Fp8Dense", ("kernel_init", "bias_init"), "JAX-only",
     "flax initializers; the port's weights come from the model's init, a generator or a "
     "loaded state dict"),
    ("accelerate_tpu.ops.quant.Fp8Dense", ("parent", "name"), "JAX-only",
     "flax's module tree plumbing; a torch module holds its submodules"),
    ("accelerate_tpu.ops.quant.wrap_optimizer_for_fp8", ("tx", "params"), "JAX-only",
     "an optax transformation over the parameter pytree; the port's takes the torch "
     "optimizer and the model whose statistics its steps commit"),
    ("accelerate_tpu.checkpointing.save_adapter", ("blocking",), "JAX-only",
     "save_array_tree's background write (a pytree helper)"),
    ("accelerate_tpu.utils.hf_interop.convert_hf_state_dict", ("to_numpy",), "JAX-only",
     "numpy or jax arrays; the port returns tensors"),
    ("accelerate_tpu.big_modeling.init_empty_weights", ("module", "rng"), "JAX-only",
     _ABSTRACT),
    ("accelerate_tpu.big_modeling.disk_offload", ("example_args",), "JAX-only", _ABSTRACT),
    ("accelerate_tpu.big_modeling.load_checkpoint_and_dispatch", ("example_args",), "JAX-only",
     _ABSTRACT),
    ("accelerate_tpu.big_modeling.load_checkpoint_in_model", ("abstract_params",), "JAX-only",
     _ABSTRACT),
    ("accelerate_tpu.utils.quantization.load_and_quantize_model", ("expected_params",),
     "JAX-only", _ABSTRACT),
    ("accelerate_tpu.generation.generate", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.generation.generate", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.generation.greedy_generate", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.generation.seq2seq_generate", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.generation.seq2seq_generate", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.generation.beam_search_generate", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.generation.prompt_lookup_generate", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.generation.prompt_lookup_generate", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.generation.assisted_generate", ("params", "draft_params"), "JAX-only",
     _PYTREE),
    ("accelerate_tpu.generation.assisted_generate", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.generation.speculative_accept", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.generation.speculative_emit", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.serving.engine.ServingEngine", ("params", "draft_params"), "JAX-only",
     _PYTREE),
    ("accelerate_tpu.adapters.registry.AdapterBank", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.adapters.quantize.quantize_base_weights", ("params",), "JAX-only",
     _PYTREE),
    ("accelerate_tpu.adapters.quantize.shardings_for_quantized", ("qparams",), "JAX-only",
     "a quantized parameter pytree; the port's function takes the quantized module"),
    ("accelerate_tpu.adapters.lora.LoRATrainState", ("base_params", "param_mask"), "JAX-only",
     _PYTREE),
    ("accelerate_tpu.adapters.lora.init_lora_params", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.adapters.lora.init_lora_params", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.adapters.lora.prepare_lora", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.adapters.lora.prepare_lora", ("rng",), "JAX-only", _KEY),
    ("accelerate_tpu.adapters.lora.merge_adapter", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.adapters.lora.target_paths", ("params",), "JAX-only", _PYTREE),
    ("accelerate_tpu.adapters.lora.count_lora_params", ("abstract_params",), "JAX-only",
     _ABSTRACT),
    ("accelerate_tpu.models.llama.causal_lm_loss", ("apply_fn",), "JAX-only",
     "a flax apply function; the port's loss takes the model"),
    *[(f"accelerate_tpu.models.{name}", ("parent", "name"), "JAX-only",
       "flax's module tree plumbing; a torch module holds its submodules")
      for name in ("mixtral.MixtralSparseMLP", "mixtral.MixtralBlock",
                   "mixtral.MixtralForCausalLM", "llama.RMSNorm", "llama.LlamaAttention",
                   "llama.LlamaMLP", "llama.LlamaBlock", "llama.LlamaModel",
                   "llama.LlamaForCausalLM", "gpt2.GPT2Block", "gpt2.GPT2LMHeadModel",
                   "opt.OPTBlock", "opt.OPTForCausalLM", "gptj.GPTJBlock",
                   "gptj.GPTJForCausalLM", "gpt_neox.GPTNeoXBlock",
                   "gpt_neox.GPTNeoXForCausalLM", "phi.PhiBlock", "phi.PhiForCausalLM",
                   "bloom.BloomBlock", "bloom.BloomForCausalLM", "bert.BertSelfAttention",
                   "bert.BertLayer", "bert.BertEncoder", "bert.BertForSequenceClassification",
                   "resnet.ResNet", "resnet.BottleneckBlock", "resnet.BasicBlock",
                   "simple.MLP", "simple.RegressionModel", "t5.T5LayerNorm", "t5.T5Attention",
                   "t5.T5MLP", "t5.T5EncoderBlock", "t5.T5DecoderBlock",
                   "t5.T5ForConditionalGeneration", "vit.ViTSelfAttention", "vit.ViTBlock",
                   "vit.ViTForImageClassification")],
    ("accelerate_tpu.models.mixtral.mixtral_lm_loss", ("apply_fn",), "JAX-only",
     "a flax apply function; the port's loss takes the model"),
    ("accelerate_tpu.models.bert.classification_loss", ("apply_fn",), "JAX-only",
     "a flax apply function; the port's loss takes the model"),
    ("accelerate_tpu.models.t5.seq2seq_lm_loss", ("apply_fn",), "JAX-only",
     "a flax apply function; the port's loss takes the model"),
    *[(f"accelerate_tpu.models.t5.{name}", ("deterministic",), "JAX-only",
       "flax's dropout switch; a port module drops out when its forward is given a "
       "torch.Generator")
      for name in ("T5Attention", "T5MLP", "T5EncoderBlock", "T5DecoderBlock")],
]


def _home(obj, module_name: str, name: str) -> str:
    home = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if home and qual and callable(obj):
        return f"{home}.{qual}"
    return f"{module_name}:{name}"


def public_names(module) -> dict:
    """A package's public re-exports (what its ``__init__`` binds, modules
    aside); a module's own public classes and functions."""
    package = hasattr(module, "__path__")
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        home = getattr(obj, "__module__", None)
        if package:
            if home is None or home.split(".")[0] == "accelerate_tpu":
                out[name] = obj
        elif home == module.__name__ and callable(obj) and hasattr(obj, "__qualname__"):
            out[name] = obj
    return out


def keywords(obj) -> list:
    target = obj.__init__ if inspect.isclass(obj) else obj
    try:
        params = inspect.signature(target).parameters.values()
    except (TypeError, ValueError):
        return []
    return [p.name for p in params if p.name != "self" and not p.name.startswith("_")
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _own_bases(cls) -> list:
    """The names of ``cls``'s base classes that the package defines."""
    return [b.__name__ for b in cls.__mro__[1:]
            if (b.__module__ or "").split(".")[0] == "accelerate_tpu"]


def gaps(suffix: str):
    """``(missing names, missing keywords)`` of one module, keyed by the
    reference object's home (a method's home is its class's, dotted; a
    base class's is the class's, with the base in angle brackets)."""
    ref = importlib.import_module("accelerate_tpu" + suffix)
    port = importlib.import_module("accelerate_tpu_torch" + suffix)
    missing, lacking = {}, {}
    for name, obj in public_names(ref).items():
        home = _home(obj, ref.__name__, name)
        if not hasattr(port, name):
            missing[home] = name
            continue
        target = getattr(port, name)
        if inspect.isclass(obj) and inspect.isclass(target):
            for attr in vars(obj):
                if not attr.startswith("_") and callable(getattr(obj, attr)) \
                        and not hasattr(target, attr):
                    missing[f"{home}.{attr}"] = attr
            have = {b.__name__ for b in target.__mro__}
            for base in _own_bases(obj):
                if base not in have:
                    missing[f"{home}<{base}>"] = base
        if callable(obj) and callable(target):
            have = set(keywords(target))
            absent = [k for k in keywords(obj) if k not in have]
            if absent:
                lacking[home] = absent
    return missing, lacking


def allowed_keywords(home: str) -> set:
    return {k for h, kws, _, _ in KEYWORDS_OK if h == home for k in kws}


@pytest.mark.parametrize("suffix", MODULES, ids=lambda s: "accelerate_tpu" + (s or ""))
def test_module_surface_matches_the_reference(suffix):
    missing, lacking = gaps(suffix)
    unexplained = sorted(h for h in missing if h not in MISSING_OK)
    assert not unexplained, f"public names the port lacks: {unexplained}"
    bad = {h: sorted(set(kws) - allowed_keywords(h)) for h, kws in lacking.items()}
    bad = {h: kws for h, kws in bad.items() if kws}
    assert not bad, f"keywords the port lacks: {bad}"


def test_allow_list_only_holds_what_is_still_missing():
    """An entry for a name or keyword the port now has fails: the list
    shrinks as the port grows."""
    missing, lacking = {}, {}
    for suffix in MODULES:
        m, k = gaps(suffix)
        missing.update(m)
        for home, kws in k.items():
            lacking.setdefault(home, set()).update(kws)
    stale = [h for h in MISSING_OK if h not in missing]
    stale += [f"{h}({k})" for h, kws, _, _ in KEYWORDS_OK for k in kws
              if k not in lacking.get(h, set())]
    assert not stale, f"allow-list entries the port no longer needs: {stale}"


def test_allow_list_entries_are_tagged_and_explained():
    entries = list(MISSING_OK.values()) + [(tag, reason) for _, _, tag, reason in KEYWORDS_OK]
    assert all(tag in TAGS and reason for tag, reason in entries)
    # The names the port has are off the list.
    for home in ("accelerate_tpu.local_sgd.LocalSGD", "accelerate_tpu.launchers.debug_launcher",
                 "accelerate_tpu.utils.dataclasses.DistributedType",
                 "accelerate_tpu.utils.dataclasses.GradScalerKwargs",
                 "accelerate_tpu.commands.config.config.get_user_input",
                 "accelerate_tpu.utils.environment.override_numa_affinity",
                 "accelerate_tpu.models.llama.LlamaModel",
                 "accelerate_tpu.ops.ring_attention.ring_attention"):
        assert home not in MISSING_OK


def test_the_walk_covers_every_shared_module_and_holds_kwargs_handlers():
    """Every module both packages have is walked (88 when the walk was
    widened), and the configuration dataclasses the JAX package makes
    ``KwargsHandler``s are ones here too."""
    assert len(MODULES) >= 88 and "" in MODULES and ".commands.config" in MODULES
    from accelerate_tpu_torch.utils import dataclasses as ours

    for name in ("GradScalerKwargs", "GradientAccumulationPlugin", "DataLoaderConfiguration",
                 "ProjectConfiguration"):
        cls = getattr(ours, name)
        assert issubclass(cls, ours.KwargsHandler), name
        assert cls().to_kwargs() == {}, name


def test_wait_for_everyone_takes_a_tag_and_a_mismatch_raises(monkeypatch):
    """In a gloo world of one the tagged barrier passes (and the
    main-first blocks with their tags); a process whose peers are at a
    barrier of another tag raises, as ``sync_global_devices`` does."""
    import socket

    import torch
    import torch.distributed as dist

    from accelerate_tpu_torch.state import AcceleratorState, PartialState

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("ACCELERATE_TPU_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("ACCELERATE_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("ACCELERATE_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("ACCELERATE_TPU_USE_CPU", "true")
    try:
        state = PartialState()
        assert state.process_group
        state.wait_for_everyone("checkpoint")
        with state.main_process_first():
            pass
        real = dist.all_gather

        def peer_at_another_barrier(outputs, mine, *args, **kwargs):
            outputs[0].copy_(mine)
            outputs[1].copy_(mine + 1)

        monkeypatch.setattr(dist, "all_gather", peer_at_another_barrier)
        monkeypatch.setattr(state, "num_processes", 2)
        with pytest.raises(RuntimeError, match="tag mismatch"):
            state.wait_for_everyone("save")
        monkeypatch.setattr(dist, "all_gather", real)
        monkeypatch.setattr(state, "num_processes", 1)
        assert torch.distributed.get_world_size() == 1
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)


def test_numa_affinity_reads_the_topology_and_binds_only_where_nodes_differ(monkeypatch):
    """``override_numa_affinity`` parses sysfs cpulists as the JAX package
    does and leaves a one-node machine (or one without sysfs nodes) as it
    is; on several nodes it binds the process to its node's CPUs."""
    import os

    from accelerate_tpu_torch.utils import environment

    assert environment._cpus_of("0-3,8,10-11\n") == {0, 1, 2, 3, 8, 10, 11}
    assert environment._card_numa_node(0) is None  # no card here
    before = os.sched_getaffinity(0)
    environment.override_numa_affinity(0)
    listing = {"node0", "node1", "possible"}
    monkeypatch.setattr(environment.os, "listdir", lambda path: sorted(listing))
    bound = []
    monkeypatch.setattr(environment.os, "sched_setaffinity",
                        lambda pid, cpus: bound.append((pid, set(cpus))))
    real_open = open

    def fake_open(path, *args, **kwargs):
        if str(path).endswith("node1/cpulist"):
            import io

            return io.StringIO("4-5,7")
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr("builtins.open", fake_open)
    environment.override_numa_affinity(3)  # nodes dealt out by local index: node 1
    assert bound == [(0, {4, 5, 7})]
    assert os.sched_getaffinity(0) == before


def test_weight_store_fetch_subtree_gives_the_prefix_by_relative_name(tmp_path):
    import torch

    from accelerate_tpu_torch.big_modeling import LazyWeight, WeightStore
    from accelerate_tpu_torch.checkpointing import save_safetensors

    save_safetensors({"w": torch.arange(6.0).reshape(2, 3)}, tmp_path / "s.safetensors")
    store = WeightStore()
    store.put("layers.0.mlp.w", LazyWeight(str(tmp_path / "s.safetensors"), "w",
                                           dtype=torch.bfloat16), "disk")
    store.put("layers.0.norm", torch.ones(3), "cpu")
    store.put("layers.1.norm", torch.zeros(3), "cpu")
    got = store.fetch_subtree("layers.0", device="cpu")
    assert sorted(got) == ["mlp.w", "norm"]
    assert got["mlp.w"].dtype == torch.bfloat16
    assert torch.equal(got["mlp.w"].float(), torch.arange(6.0).reshape(2, 3))


def test_flash_tile_keywords_are_taken_and_change_nothing():
    import numpy as np
    import torch

    from accelerate_tpu_torch.models.llama import multi_head_attention
    from accelerate_tpu_torch.ops import flash_attention

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    want = flash_attention(q, k, v)
    for block in (8, 64, 128, 512):
        assert torch.equal(flash_attention(q, k, v, block_q=block, block_k=block), want)
        assert torch.equal(multi_head_attention(q, k, v, block_q=block, block_k=block), want)
