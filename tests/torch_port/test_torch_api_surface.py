"""The port's public surface against the JAX package's.

Walks the reference's public modules, and fails on a public name, or a
keyword of a public function or class, that the port's counterpart module
lacks. The allow-list holds two kinds of entry, each with its reason: what
ROADMAP items A8d and A9 still owe, tagged with the item, and what
only the JAX design has (the parameter pytree and PRNG keys a JAX function
takes, meshes of XLA shardings, the pytree helpers, the JAX and TPU
probes). An entry the port no longer needs fails too, so the list shrinks
as names are ported.
"""

import importlib
import inspect
import types

import pytest

MODULES = ["", ".utils", ".state", ".accelerator", ".data_loader", ".scheduler",
           ".checkpointing", ".generation", ".tracking", ".big_modeling", ".utils.modeling",
           ".utils.operations", ".launchers", ".local_sgd", ".commands.launch",
           ".parallel.sharding", ".parallel.host_offload", ".commands.merge",
           ".parallel.mesh", ".parallel.pipeline", ".ops.ring_attention", ".inference",
           ".ops.moe", ".models.mixtral", ".serving.mesh_exec", ".serving.engine",
           ".serving.router", ".adapters.quantize", ".adapters.registry"]

#: Modules whose public classes are also held method for method.
METHOD_MODULES = {".serving.mesh_exec"}

TAGS = {"A8d", "A9", "JAX-only"}
_PYTREE = "a JAX function takes the parameter pytree; a torch module holds its parameters"
_KEY = "a JAX PRNG key; the port's functions take a torch.Generator"
_ABSTRACT = "flax's abstract init over example inputs; a torch module is built on the meta device"

#: Reference names the port does not have, by their home in the reference.
MISSING_OK = {
    "accelerate_tpu.utils.dataclasses.FP8RecipeKwargs": ("A9", "the fp8 path"),
    "accelerate_tpu.utils.dataclasses.JitConfig": ("JAX-only", "jax.jit options"),
    "accelerate_tpu.parallel.sharding.replicated_sharding": (
        "JAX-only", "a NamedSharding over a mesh; a replicated leaf's spec is PartitionSpec()"),
    "accelerate_tpu.parallel.sharding.zero_step_compile_cache_guard": (
        "JAX-only", "keeps ZeRO executables out of XLA's persistent compile cache"),
    "accelerate_tpu.parallel.host_offload.shardings_like": (
        "JAX-only", "NamedShardings with a memory kind; a tensor's place is its device"),
    "accelerate_tpu.generation.seq2seq_generate": ("A9", "comes with T5"),
    **{f"accelerate_tpu.tracking.{name}": (
        "A9", "a third-party tracker; it comes with tests over fakes of its library")
       for name in ("WandBTracker", "MLflowTracker", "CometMLTracker", "AimTracker",
                    "ClearMLTracker", "DVCLiveTracker")},
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
    ("accelerate_tpu.checkpointing.load_safetensors_model", ("threads",), "A9",
     "the threaded reader comes with native/ host IO"),
    ("accelerate_tpu.checkpointing.save_adapter", ("blocking",), "JAX-only",
     "save_array_tree's background write (a pytree helper)"),
    ("accelerate_tpu.big_modeling.BlockSpec", ("stage",), "A9",
     "encoder and decoder stages come with T5"),
    ("accelerate_tpu.big_modeling.StreamedModel", ("position_bound",), "A9",
     "comes with the learned-position families"),
    ("accelerate_tpu.utils.hf_interop.export_hf_state_dict", ("config",), "A9",
     "comes with vit"),
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
    *[(f"accelerate_tpu.models.mixtral.{name}", ("parent", "name"), "JAX-only",
       "flax's module tree plumbing; a torch module holds its submodules")
      for name in ("MixtralSparseMLP", "MixtralBlock", "MixtralForCausalLM")],
    ("accelerate_tpu.models.mixtral.mixtral_lm_loss", ("apply_fn",), "JAX-only",
     "a flax apply function; the port's loss takes the model"),
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


def gaps(suffix: str):
    """``(missing names, missing keywords)`` of one module, keyed by the
    reference object's home."""
    ref = importlib.import_module("accelerate_tpu" + suffix)
    port = importlib.import_module("accelerate_tpu_torch" + suffix)
    missing, lacking = {}, {}
    for name, obj in public_names(ref).items():
        home = _home(obj, ref.__name__, name)
        if not hasattr(port, name):
            missing[home] = name
            continue
        target = getattr(port, name)
        if suffix in METHOD_MODULES and inspect.isclass(obj):
            for attr, member in vars(obj).items():
                if not attr.startswith("_") and callable(getattr(obj, attr)) \
                        and not hasattr(target, attr):
                    missing[f"{home}.{attr}"] = attr
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
    # The names this slice ported are off the list.
    for home in ("accelerate_tpu.local_sgd.LocalSGD", "accelerate_tpu.launchers.debug_launcher",
                 "accelerate_tpu.utils.dataclasses.DistributedType",
                 "accelerate_tpu.tracking.with_fleet_metrics",
                 "accelerate_tpu.utils.dataclasses.FullyShardedDataParallelPlugin",
                 "accelerate_tpu.utils.dataclasses.DeepSpeedPlugin"):
        assert home not in MISSING_OK
