"""Checkpoints: save and restore the whole training state, export weights.

Counterpart of ``accelerate_tpu/checkpointing.py``: ``get_rng_state`` /
``set_rng_state`` (``:273-300``), ``save_accelerator_state`` (``:333``),
``load_accelerator_state`` (``:417``), ``save_model`` (``:554``) and
``load_safetensors_model`` (``:600``), with the JAX package's directory
layout and file names (``checkpoint_<i>`` with ``total_limit`` rotation,
``optimizer_meta_<i>.json``, ``scheduler.json``, ``sampler_<i>.json``,
``custom_checkpoint_<i>``, ``random_states_<i>.json``).

Where the JAX package writes arrays through orbax, the port writes tensors
in the safetensors format, read and written here (an 8-byte little-endian
header length, a JSON header, then the raw bytes; bf16 goes through a
``uint8`` view, since numpy has no bf16). The model file holds the f32
masters; the optimizer file holds the torch optimizer's state tensors, its
``param_groups`` going to ``optimizer_meta_<i>.json``.

``save_state(blocking=False)`` copies every tensor to host memory before it
returns (so the next update cannot change what is saved) and writes the
files from a background thread; the next save or load, and
``Accelerator.wait_for_checkpoint``, wait for it and raise its error.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import shutil
import struct
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .logging import get_logger
from .state import PartialState
from .utils.constants import (
    CHECKPOINT_DIR_PREFIX,
    CUSTOM_OBJECTS_NAME,
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    SAMPLER_NAME,
    SCHEDULER_NAME,
    WEIGHTS_PATTERN,
)

logger = get_logger(__name__)

# ---------------------------------------------------------------------------
# The safetensors format
# ---------------------------------------------------------------------------

_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
           torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
           torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_FROM_NAME = {name: dtype for dtype, name in _DTYPES.items()}


def save_safetensors(tensors: dict, path, metadata: Optional[dict] = None):
    """Write ``{name: tensor}`` as one safetensors file (tensors on any
    device; they are read to the host)."""
    header, offset, host = {}, 0, {}
    for name, t in tensors.items():
        if t.dtype not in _DTYPES:
            raise TypeError(f"safetensors has no dtype for {name!r}: {t.dtype}")
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        host[name] = t
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in host.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def load_safetensors(path) -> dict:
    """Read a safetensors file into ``{name: CPU tensor}``."""
    with open(path, "rb") as f:
        (length,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(length))
        start = 8 + length
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _FROM_NAME.get(info["dtype"])
            if dtype is None:
                raise TypeError(f"unsupported safetensors dtype {info['dtype']} of {name!r}")
            lo, hi = info["data_offsets"]
            f.seek(start + lo)
            buf = bytearray(hi - lo)
            if f.readinto(buf) != hi - lo:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            flat = (torch.frombuffer(buf, dtype=torch.uint8) if buf
                    else torch.empty(0, dtype=torch.uint8))
            out[name] = flat.view(dtype).reshape(info["shape"])
    return out


# ---------------------------------------------------------------------------
# Adapter-only checkpoints (LoRA)
# ---------------------------------------------------------------------------

ADAPTER_META_NAME = "adapter.json"
ADAPTER_WEIGHTS_NAME = "adapter.safetensors"
ADAPTER_FORMAT = "accelerate-tpu-lora"


def save_adapter(adapter: dict, path, *, config=None) -> str:
    """Write an adapter-only checkpoint (JAX ``checkpointing.py:220``): the
    factors as ``<path>/adapter.safetensors`` (``<module>.a`` / ``.b`` /
    ``.scale``, f32) and the hyperparameters as ``<path>/adapter.json``. A
    few MB whatever the base model's size; training (``prepare_lora``)
    writes it and serving (``AdapterBank.register``) reads it."""
    from .adapters.lora import adapter_module_paths, adapter_rank

    paths = adapter_module_paths(adapter)
    if not paths:
        raise ValueError("not an adapter: no {'a','b','scale'} modules found")
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    meta = {"format": ADAPTER_FORMAT, "version": 1, "rank": adapter_rank(adapter),
            "modules": paths}
    if config is not None:
        meta.update({"alpha": float(config.alpha), "dropout": float(config.dropout),
                     "target_modules": list(config.target_modules)})
    tensors = {f"{p}.{k}": torch.as_tensor(adapter[p][k]).detach().to("cpu", torch.float32)
               for p in paths for k in ("a", "b", "scale")}
    save_safetensors(tensors, path / ADAPTER_WEIGHTS_NAME, {"format": ADAPTER_FORMAT})
    (path / ADAPTER_META_NAME).write_text(json.dumps(meta, indent=2))
    return str(path)


def load_adapter(path):
    """``(adapter, meta)`` from a directory :func:`save_adapter` wrote (JAX
    ``checkpointing.py:253``); the tensors on the CPU."""
    path = Path(path).absolute()
    meta_path = path / ADAPTER_META_NAME
    if not meta_path.exists():
        raise FileNotFoundError(f"{path} is not an adapter checkpoint (missing "
                                f"{ADAPTER_META_NAME})")
    meta = json.loads(meta_path.read_text())
    if meta.get("format") != ADAPTER_FORMAT:
        raise ValueError(f"{path} has format {meta.get('format')!r}, expected "
                         f"{ADAPTER_FORMAT!r}")
    flat = load_safetensors(path / ADAPTER_WEIGHTS_NAME)
    adapter: dict = {}
    for name, tensor in flat.items():
        module, leaf = name.rsplit(".", 1)
        adapter.setdefault(module, {})[leaf] = tensor
    return adapter, meta


# ---------------------------------------------------------------------------
# RNG state
# ---------------------------------------------------------------------------

def get_rng_state(accelerator=None) -> dict:
    """Python's, numpy's and torch's generators (CPU and each card), and the
    accelerator's own, as JSON-ready values."""
    py = random.getstate()
    np_state = np.random.get_state()
    state = {"python": [py[0], list(py[1]), py[2]],
             "numpy": [np_state[0], np_state[1].tolist(), *np_state[2:]],
             "torch": torch.get_rng_state().tolist()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = [s.tolist() for s in torch.cuda.get_rng_state_all()]
    if accelerator is not None:
        state["generator"] = accelerator.generator.get_state().tolist()
    return state


def set_rng_state(state: dict, accelerator=None):
    """Restore what :func:`get_rng_state` returned."""
    if "python" in state:
        py = state["python"]
        random.setstate((py[0], tuple(py[1]), py[2]))
    if "numpy" in state:
        np_state = state["numpy"]
        np.random.set_state((np_state[0], np.array(np_state[1], dtype=np.uint32),
                             *np_state[2:]))
    if "torch" in state:
        torch.set_rng_state(torch.tensor(state["torch"], dtype=torch.uint8))
    if "cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all([torch.tensor(s, dtype=torch.uint8) for s in state["cuda"]])
    if accelerator is not None and "generator" in state:
        accelerator.generator.set_state(torch.tensor(state["generator"], dtype=torch.uint8))


# ---------------------------------------------------------------------------
# Background writes
# ---------------------------------------------------------------------------

class _PendingSave:
    """A checkpoint write running on a background thread; :meth:`wait`
    joins it and raises what it raised."""

    def __init__(self, writes: list, out: Path):
        self.out = out
        self.error: Optional[BaseException] = None
        # Not a daemon: an exiting interpreter waits for the write.
        self._thread = threading.Thread(target=self._run, args=(writes,),
                                        name="atpu-checkpoint-write")
        self._thread.start()

    def _run(self, writes):
        try:
            for write in writes:
                write()
        except BaseException as exc:  # noqa: BLE001 - re-raised by wait()
            self.error = exc

    def wait(self):
        self._thread.join()
        if self.error is not None:
            raise RuntimeError(f"the checkpoint write to {self.out} failed") from self.error


def wait_for_saves(accelerator) -> None:
    """Block until every background checkpoint write of ``accelerator`` is
    on disk; raise the first one's error."""
    pending, accelerator._pending_saves = accelerator._pending_saves, []
    for save in pending:
        save.wait()


# ---------------------------------------------------------------------------
# save_state / load_state
# ---------------------------------------------------------------------------

def _checkpoint_dir(accelerator, output_dir: Optional[str], for_load: bool = False) -> Path:
    pc = accelerator.project_configuration
    if output_dir is not None:
        return Path(output_dir)
    if pc.project_dir is None:
        raise ValueError("No output_dir given and no ProjectConfiguration.project_dir set.")
    base = Path(pc.project_dir) / "checkpoints"
    if pc.automatic_checkpoint_naming:
        if for_load:
            existing = _checkpoints_in(base)
            if not existing:
                raise FileNotFoundError(f"No checkpoints found in {base}")
            return existing[-1]
        return base / f"{CHECKPOINT_DIR_PREFIX}_{pc.iteration}"
    return base


def _checkpoints_in(base: Path) -> list:
    return sorted(base.glob(f"{CHECKPOINT_DIR_PREFIX}_*"), key=lambda p: int(p.name.split("_")[-1]))


def _prune_checkpoints(accelerator, out: Path):
    """``total_limit`` rotation: remove the oldest checkpoints so that,
    with the one about to be written, at most ``total_limit`` remain."""
    pc = accelerator.project_configuration
    if pc.total_limit is None:
        return
    existing = _checkpoints_in(out.parent)
    while len(existing) >= pc.total_limit:
        shutil.rmtree(existing.pop(0), ignore_errors=True)


def _indexed(name: str, i: int, suffix: str = "") -> str:
    return f"{name}_{i}{suffix}" if i > 0 else f"{name}{suffix}"


def _write_object(stem: Path, payload):
    """``payload`` as ``stem.json``, or pickled to ``stem.pkl`` when JSON
    cannot hold it."""
    try:
        text = json.dumps(payload)
    except TypeError:
        stem.with_suffix(".pkl").write_bytes(pickle.dumps(payload))
    else:
        stem.with_suffix(".json").write_text(text)


def _read_object(stem: Path):
    if stem.with_suffix(".json").exists():
        return json.loads(stem.with_suffix(".json").read_text())
    if stem.with_suffix(".pkl").exists():
        # Only files this module wrote: a checkpoint is trusted input.
        return pickle.loads(stem.with_suffix(".pkl").read_bytes())
    return None


def _host_copy(tensors: dict) -> dict:
    """Tensors copied to host memory, so later updates cannot reach them."""
    return {name: t.detach().to("cpu", copy=True) for name, t in tensors.items()}


def _split_optimizer_state(sd: dict):
    """A torch optimizer state dict as (tensors for safetensors, the rest
    for JSON)."""
    tensors, plain = {}, {}
    for pid, entries in sd["state"].items():
        for key, value in entries.items():
            if isinstance(value, torch.Tensor):
                tensors[f"state.{pid}.{key}"] = value
            else:
                plain.setdefault(str(pid), {})[key] = value
    return tensors, {"param_groups": sd["param_groups"], "state": plain}


def _join_optimizer_state(tensors: dict, meta: dict) -> dict:
    state: dict = {}
    for name, value in tensors.items():
        _, pid, key = name.split(".", 2)
        state.setdefault(int(pid), {})[key] = value
    for pid, entries in meta.get("state", {}).items():
        state.setdefault(int(pid), {}).update(entries)
    return {"state": state, "param_groups": meta["param_groups"]}


def save_accelerator_state(accelerator, output_dir: Optional[str] = None,
                           safe_serialization: bool = True, blocking: bool = True) -> str:
    """Save models, optimizers, schedulers, loader positions, custom objects
    and RNG states into one directory; return its path. ``blocking=False``
    writes the tensor files from a background thread after host copies."""
    wait_for_saves(accelerator)  # never two writes at once
    out = _checkpoint_dir(accelerator, output_dir)
    pc = accelerator.project_configuration
    automatic = pc.automatic_checkpoint_naming and output_dir is None
    if automatic:
        _prune_checkpoints(accelerator, out)
    out.mkdir(parents=True, exist_ok=True)

    writes = []
    for i, model in enumerate(accelerator._models):
        tensors = _host_copy(model.module.state_dict())
        path = out / _indexed(MODEL_NAME, i, ".safetensors")
        writes.append(lambda t=tensors, p=path: save_safetensors(t, p, {"format": "pt"}))

    for i, opt in enumerate(accelerator._optimizers):
        tensors, meta = _split_optimizer_state(opt.optimizer.state_dict())
        tensors = _host_copy(tensors)
        meta["steps_applied"] = opt.steps_applied
        if opt.loss_scale is not None:
            meta["loss_scale"] = [float(opt.loss_scale.scale), int(opt.loss_scale.growth_tracker),
                                  int(opt.loss_scale.fin_steps)]
        (out / f"optimizer_meta_{i}.json").write_text(json.dumps(meta))
        path = out / _indexed(OPTIMIZER_NAME, i, ".safetensors")
        writes.append(lambda t=tensors, p=path: save_safetensors(t, p))

    for i, sched in enumerate(accelerator._schedulers):
        _write_object(out / _indexed(SCHEDULER_NAME, i), sched.state_dict())
    for i, dl in enumerate(accelerator._dataloaders):
        (out / f"{SAMPLER_NAME}_{i}.json").write_text(json.dumps(dl.state_dict()))
    for i, obj in enumerate(accelerator._custom_objects):
        _write_object(out / f"{CUSTOM_OBJECTS_NAME}_{i}", obj.state_dict())
    rng_file = out / f"{RNG_STATE_NAME}_{PartialState().process_index}.json"
    rng_file.write_text(json.dumps(get_rng_state(accelerator)))

    if blocking:
        for write in writes:
            write()
    else:
        accelerator._pending_saves.append(_PendingSave(writes, out))
    if automatic:
        pc.iteration += 1
    logger.info(f"Saved accelerator state to {out}")
    return str(out)


def load_accelerator_state(accelerator, input_dir: Optional[str] = None) -> str:
    """Restore what :func:`save_accelerator_state` wrote into the prepared
    objects, in place; return the directory read."""
    wait_for_saves(accelerator)  # a background write must be on disk first
    src = _checkpoint_dir(accelerator, input_dir, for_load=True)
    if not src.exists():
        raise FileNotFoundError(f"Checkpoint directory {src} does not exist")

    for i, model in enumerate(accelerator._models):
        model.module.load_state_dict(load_safetensors(src / _indexed(MODEL_NAME, i,
                                                                     ".safetensors")))

    for i, opt in enumerate(accelerator._optimizers):
        meta_path = src / f"optimizer_meta_{i}.json"
        if not meta_path.exists():
            continue
        meta = json.loads(meta_path.read_text())
        tensors = load_safetensors(src / _indexed(OPTIMIZER_NAME, i, ".safetensors"))
        # The tensors were just read from the file, so the optimizer owns
        # them: nothing is shared with another optimizer.
        opt.optimizer.load_state_dict(_join_optimizer_state(tensors, meta))
        opt._steps_applied = meta.get("steps_applied", 0)
        opt._step_was_skipped = False
        if meta.get("loss_scale") is not None and opt.loss_scale is not None:
            from .precision import LossScaleState

            device = opt.loss_scale.scale.device
            scale, tracker, fin = meta["loss_scale"]
            opt.loss_scale = LossScaleState(
                torch.tensor(scale, dtype=torch.float32, device=device),
                torch.tensor(tracker, dtype=torch.int32, device=device),
                torch.tensor(fin, dtype=torch.int32, device=device))

    for i, sched in enumerate(accelerator._schedulers):
        payload = _read_object(src / _indexed(SCHEDULER_NAME, i))
        if payload is not None:
            sched.load_state_dict(payload)
    for i, dl in enumerate(accelerator._dataloaders):
        path = src / f"{SAMPLER_NAME}_{i}.json"
        if path.exists():
            dl.load_state_dict(json.loads(path.read_text()))
    for i, obj in enumerate(accelerator._custom_objects):
        payload = _read_object(src / f"{CUSTOM_OBJECTS_NAME}_{i}")
        if payload is not None:
            obj.load_state_dict(payload)
    rng_file = src / f"{RNG_STATE_NAME}_{PartialState().process_index}.json"
    if rng_file.exists():
        set_rng_state(json.loads(rng_file.read_text()), accelerator)

    # Automatic naming resumes past the loaded checkpoint, so the next save
    # does not overwrite an older one while "latest" names a newer one.
    pc = accelerator.project_configuration
    if pc.automatic_checkpoint_naming and src.name.startswith(f"{CHECKPOINT_DIR_PREFIX}_"):
        pc.iteration = int(src.name.split("_")[-1]) + 1
    logger.info(f"Loaded accelerator state from {src}")
    return str(src)


# ---------------------------------------------------------------------------
# Model export
# ---------------------------------------------------------------------------

def _parse_size(size) -> int:
    units = {"KB": 2**10, "MB": 2**20, "GB": 2**30}
    text = str(size).upper()
    for suffix, mult in units.items():
        if text.endswith(suffix):
            return int(float(text[: -len(suffix)]) * mult)
    return int(text)


def unflatten_params(flat: dict) -> dict:
    """``{'a.b.c': x}`` -> nested ``{'a': {'b': {'c': x}}}``."""
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_model(model, save_directory: str, max_shard_size="10GB",
               safe_serialization: bool = True):
    """Export the model's state dict as safetensors: one ``model.safetensors``
    or, past ``max_shard_size``, shards named ``model-0000i-of-0000n`` with
    ``model.safetensors.index.json`` mapping each tensor to its shard. Tied
    weights (one storage under two names) are written once."""
    if not safe_serialization:
        raise NotImplementedError("the port writes model files as safetensors only")
    os.makedirs(save_directory, exist_ok=True)
    module = getattr(model, "module", model)
    flat, seen = {}, set()
    for name, t in module.state_dict().items():
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape))
        if key in seen:
            continue
        seen.add(key)
        flat[name] = t
    limit = _parse_size(max_shard_size)
    shards, sizes = [{}], [0]
    for name, t in flat.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    if len(shards) == 1:
        save_safetensors(shards[0], os.path.join(save_directory, SAFE_WEIGHTS_NAME),
                         {"format": "pt"})
        return
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    for i, shard in enumerate(shards):
        name = WEIGHTS_PATTERN.format(i + 1, len(shards))
        save_safetensors(shard, os.path.join(save_directory, name), {"format": "pt"})
        for k in shard:
            index["weight_map"][k] = name
    with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)


def load_safetensors_model(save_directory: str) -> dict:
    """A model file written by :func:`save_model` (either package's), one or
    sharded, as a nested dict of CPU tensors keyed by the dotted names."""
    d = Path(save_directory)
    index_path = d / SAFE_WEIGHTS_INDEX_NAME
    flat: dict = {}
    if index_path.exists():
        index = json.loads(index_path.read_text())
        for name in sorted(set(index["weight_map"].values())):
            flat.update(load_safetensors(d / name))
    else:
        flat = load_safetensors(d / SAFE_WEIGHTS_NAME)
    return unflatten_params(flat)
