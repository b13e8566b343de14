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

Sharded training state (FSDP, ZeRO, tensor and pipeline splits): the
main process writes ``world.json`` (the saving world's size, reference
``:352-359``, and its mesh's axis sizes) and each model's and optimizer's
layout (every split tensor's whole shape and its dimension on each mesh
axis); every process writes its chunks to
``<model|optimizer>.rank<r>-of-<n>.safetensors``, the whole tensors going
to rank 0's file. ``load_state`` reads a process's own file back when the
world, the mesh and the layout are the saving ones, and otherwise
(``via_host``, default from ``world.json``) reads every file, puts each
tensor together from its chunks by the saving mesh's coordinates and keeps
this process's chunk by the current layout: a checkpoint saved by 2
processes restores into 1 or 4, one saved under tp=2 into one process
(reference ``load_array_tree`` ``:113-218``). ``merge-weights``
(``commands/merge.py``) puts a sharded model back together into one
file.
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


class SafetensorsFile:
    """One safetensors file, its header parsed once: ``keys()``, each
    tensor's ``dtype``/``shape`` (:meth:`meta`), and :meth:`read` of one
    tensor at its byte offsets, optionally into pinned host memory (the
    staging of a host-to-card copy). Nothing else of the file is read."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            (length,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(length))
        self.metadata = header.pop("__metadata__", None)
        self._start = 8 + length
        self._header = header

    def keys(self) -> list:
        return list(self._header)

    def __contains__(self, name) -> bool:
        return name in self._header

    def meta(self, name):
        """``(torch dtype, shape, nbytes)`` of tensor ``name``."""
        info = self._header[name]
        dtype = _FROM_NAME.get(info["dtype"])
        if dtype is None:
            raise TypeError(f"unsupported safetensors dtype {info['dtype']} of {name!r}")
        lo, hi = info["data_offsets"]
        return dtype, tuple(info["shape"]), hi - lo

    def read(self, name, pin: bool = False) -> torch.Tensor:
        """Tensor ``name`` as a CPU tensor of its own, in pinned memory when
        ``pin``."""
        dtype, shape, nbytes = self.meta(name)
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        if nbytes:
            view = memoryview(buf.numpy())
            with open(self.path, "rb", buffering=0) as f:
                f.seek(self._start + self._header[name]["data_offsets"][0])
                got = 0
                while got < nbytes:
                    n = f.readinto(view[got:])
                    if not n:
                        raise ValueError(f"{self.path}: tensor {name!r} runs past the end of "
                                         "the file")
                    got += n
        return buf.view(dtype).reshape(shape)


def load_safetensors(path) -> dict:
    """Read a safetensors file into ``{name: CPU tensor}``."""
    f = SafetensorsFile(path)
    return {name: f.read(name) for name in f.keys()}


def checkpoint_shards(checkpoint) -> list:
    """The :class:`SafetensorsFile` of each shard of a checkpoint: a
    safetensors file, a directory with ``model.safetensors.index.json``
    (its shards in name order), or a directory with ``model.safetensors``."""
    checkpoint = str(checkpoint)
    if os.path.isfile(checkpoint):
        paths = [checkpoint]
    else:
        index = os.path.join(checkpoint, SAFE_WEIGHTS_INDEX_NAME)
        if os.path.isfile(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            paths = [os.path.join(checkpoint, s) for s in sorted(set(weight_map.values()))]
        else:
            single = os.path.join(checkpoint, SAFE_WEIGHTS_NAME)
            if not os.path.isfile(single):
                raise FileNotFoundError(f"No safetensors checkpoint under {checkpoint}")
            paths = [single]
    return [SafetensorsFile(p) for p in paths]


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


WORLD_NAME = "world.json"


def _rank_file(stem: str, rank: int, world: int) -> str:
    return f"{stem}.rank{rank}-of-{world}.safetensors"


def _splits_of(entry: dict) -> dict:
    """``{axis: dim}`` of a layout entry (an entry of a checkpoint written
    before meshes names one ``dim`` over the process group's ``fsdp``)."""
    if "splits" in entry:
        return dict(entry["splits"])
    return {"fsdp": entry["dim"]} if entry.get("dim") is not None else {}


def _coords(sizes: dict, rank: int) -> dict:
    """Process ``rank``'s coordinates on a mesh of ``sizes`` (row-major in
    the mesh's axis order)."""
    from .parallel.mesh import AXIS_ORDER

    out = {}
    for ax in reversed(AXIS_ORDER):
        n = int(sizes.get(ax, 1))
        out[ax] = rank % n
        rank //= n
    return out


def _mesh_chunk(tensor: torch.Tensor, splits: dict, sizes: dict, coords: dict) -> torch.Tensor:
    """The chunk of the whole ``tensor`` that the process at ``coords`` of
    a mesh of ``sizes`` holds."""
    from .parallel.sharding import chunk_of

    for ax, d in splits.items():
        tensor = chunk_of(tensor, d, coords.get(ax, 0), int(sizes.get(ax, 1)))
    return tensor


def _chunks_to_write(tensors: dict, layout: dict, rank: int) -> dict:
    """What process ``rank`` writes of ``tensors`` (its own, as stored):
    its chunks of the split ones, and on rank 0 the whole ones."""
    return {k: t for k, t in tensors.items() if _splits_of(layout.get(k, {})) or rank == 0}


def _read_sharded(src: Path, stem: str, layout: dict, world: int, rank: Optional[int],
                  sizes: Optional[dict] = None) -> dict:
    """The tensors of a sharded save under ``stem``: process ``rank``'s own
    (its chunks, and the whole ones from rank 0's file), or with ``rank``
    None every tensor put back together from the chunks of the saving
    mesh (``sizes``, default the process group as ``fsdp``)."""
    if rank is not None:
        own = load_safetensors(src / _rank_file(stem, rank, world))
        first = own if rank == 0 else load_safetensors(src / _rank_file(stem, 0, world))
        return {k: (own[k] if _splits_of(layout.get(k, {})) else first[k])
                for k in first.keys() | own.keys()}
    sizes = sizes or {"fsdp": world}
    files = [load_safetensors(src / _rank_file(stem, r, world)) for r in range(world)]
    out = dict(files[0])
    for key, entry in layout.items():
        splits = _splits_of(entry)
        if not splits or key not in files[0]:
            continue
        whole = torch.empty(entry["shape"], dtype=files[0][key].dtype)
        for r, f in enumerate(files):
            _mesh_chunk(whole, splits, sizes, _coords(sizes, r)).copy_(f[key])
        out[key] = whole
    return out


def _read_layout(src: Path, stem: str) -> Optional[dict]:
    """A sharded model save's layout, or None (a whole-model save)."""
    path = src / f"{stem}.layout.json"
    return json.loads(path.read_text()) if path.exists() else None


def _read_world(src: Path) -> dict:
    path = src / WORLD_NAME
    return json.loads(path.read_text()) if path.exists() else {}


def _saved_world(src: Path) -> Optional[int]:
    return _read_world(src).get("process_count")


def _saved_mesh(src: Path, world: Optional[int]) -> Optional[dict]:
    """The saving mesh's axis sizes (a checkpoint written before meshes:
    the process group as ``fsdp``)."""
    mesh = _read_world(src).get("mesh")
    if mesh is not None:
        return mesh
    return {"fsdp": world} if world is not None else None


def _mesh_sizes(accelerator) -> dict:
    """The axis sizes of ``accelerator``'s mesh above one (``{"fsdp": 1}``
    for a mesh of ones), as ``world.json`` records them."""
    return {ax: s for ax, s in accelerator.mesh.shape.items() if s > 1} or {"fsdp": 1}


def _model_layout(model) -> Optional[dict]:
    layout = getattr(model, "layout", None)
    if layout is None:
        return None
    return {name: {"shape": list(layout.full_shapes[name]), "dim": layout.dims[name],
                   "splits": layout.splits[name]}
            for name in layout.full_shapes}


def _optimizer_layout(opt, tensors: dict) -> Optional[dict]:
    """Each state tensor's whole shape and splits (``state.<pid>.<key>``),
    when the optimizer steps chunks; else None."""
    if not getattr(opt, "_chunk_layout", None):
        return None
    layouts = opt.param_splits()
    params = opt._params()
    out = {}
    for key, t in tensors.items():
        _, pid, _ = key.split(".", 2)
        splits, whole = layouts[int(pid)]
        shaped = bool(splits) and tuple(t.shape) == tuple(params[int(pid)].shape)
        out[key] = {"shape": list(whole) if shaped else list(t.shape),
                    "dim": next(iter(splits.values())) if shaped and len(splits) == 1 else None,
                    "splits": splits if shaped else {}}
    return out


def _chunk_state(opt, tensors: dict, sizes: dict, coords: dict) -> dict:
    """Whole optimizer-state tensors cut to this process's chunks by the
    optimizer's current layout (a tensor shaped like its whole parameter
    is cut along the parameter's splits)."""
    layouts = opt.param_splits()
    out = {}
    for key, t in tensors.items():
        _, pid, _ = key.split(".", 2)
        splits, whole = layouts[int(pid)]
        if splits and tuple(t.shape) == tuple(whole):
            t = _mesh_chunk(t, splits, sizes, coords).contiguous()
        out[key] = t
    return out


def save_accelerator_state(accelerator, output_dir: Optional[str] = None,
                           safe_serialization: bool = True, blocking: bool = True) -> str:
    """Save models, optimizers, schedulers, loader positions, custom objects
    and RNG states into one directory; return its path. ``blocking=False``
    writes the tensor files from a background thread after host copies.

    In a process group the replicated objects are written by the main
    process only, and each process writes its own RNG states; every
    process then waits for the others (a background write is on disk
    after ``wait_for_checkpoint``, which the next load runs first)."""
    wait_for_saves(accelerator)  # never two writes at once
    state = PartialState()
    main = state.is_main_process
    rank, world = state.process_index, state.num_processes
    out = _checkpoint_dir(accelerator, output_dir)
    pc = accelerator.project_configuration
    automatic = pc.automatic_checkpoint_naming and output_dir is None
    if automatic and main:
        _prune_checkpoints(accelerator, out)
    state.wait_for_everyone()  # nobody writes into a directory being pruned
    out.mkdir(parents=True, exist_ok=True)
    rng_file = out / f"{RNG_STATE_NAME}_{state.process_index}.json"
    rng_file.write_text(json.dumps(get_rng_state(accelerator)))
    if main:
        (out / WORLD_NAME).write_text(json.dumps({"process_count": world,
                                                  "device_count": world,
                                                  "mesh": _mesh_sizes(accelerator)}))

    writes = []
    for i, model in enumerate(accelerator._models):
        layout = _model_layout(model)
        stem = _indexed(MODEL_NAME, i)
        if layout is None:
            if main:
                tensors = _host_copy(model.module.state_dict())
                path = out / (stem + ".safetensors")
                writes.append(lambda t=tensors, p=path: save_safetensors(t, p, {"format": "pt"}))
            continue
        if main:
            (out / f"{stem}.layout.json").write_text(json.dumps(layout))
        tensors = _host_copy(_chunks_to_write(model.module.state_dict(), layout, rank))
        path = out / _rank_file(stem, rank, world)
        writes.append(lambda t=tensors, p=path: save_safetensors(t, p, {"format": "pt"}))

    for i, opt in enumerate(accelerator._optimizers):
        tensors, meta = _split_optimizer_state(opt.optimizer.state_dict())
        layout = _optimizer_layout(opt, tensors)
        stem = _indexed(OPTIMIZER_NAME, i)
        if main:
            meta["steps_applied"] = opt.steps_applied
            if opt.loss_scale is not None:
                meta["loss_scale"] = [float(opt.loss_scale.scale),
                                      int(opt.loss_scale.growth_tracker),
                                      int(opt.loss_scale.fin_steps)]
            if layout is not None:
                meta["layout"] = layout
            (out / f"optimizer_meta_{i}.json").write_text(json.dumps(meta))
        if layout is None:
            if main:
                path = out / (stem + ".safetensors")
                writes.append(lambda t=_host_copy(tensors), p=path: save_safetensors(t, p))
            continue
        path = out / _rank_file(stem, rank, world)
        mine = _host_copy(_chunks_to_write(tensors, layout, rank))
        writes.append(lambda t=mine, p=path: save_safetensors(t, p))

    if main:
        for i, sched in enumerate(accelerator._schedulers):
            _write_object(out / _indexed(SCHEDULER_NAME, i), sched.state_dict())
        for i, dl in enumerate(accelerator._dataloaders):
            (out / f"{SAMPLER_NAME}_{i}.json").write_text(json.dumps(dl.state_dict()))
        for i, obj in enumerate(accelerator._custom_objects):
            _write_object(out / f"{CUSTOM_OBJECTS_NAME}_{i}", obj.state_dict())

    if blocking:
        for write in writes:
            write()
    elif writes:
        accelerator._pending_saves.append(_PendingSave(writes, out))
    if automatic:
        pc.iteration += 1
    state.wait_for_everyone()
    logger.info(f"Saved accelerator state to {out}")
    return str(out)


def _restore(src: Path, stem: str, layout: Optional[dict], saved: Optional[int], via_host: bool,
             rank: int, world: int, current_splits=None, sizes: Optional[dict] = None):
    """``(tensors, whole)``: a save's tensors under ``stem``, this process's
    own as stored (``whole`` False) when the world, the mesh (``sizes``,
    this process's) and every tensor's splits (``current_splits(key,
    entry)``, ``{}`` when the target is not split) are the saving ones and
    not ``via_host``; else every tensor whole."""
    if layout is None:
        return load_safetensors(src / (stem + ".safetensors")), True
    if saved is None:
        saved = len(list(src.glob(f"{stem}.rank*-of-*.safetensors")))
    saved_mesh = _saved_mesh(src, saved)
    same = (saved == world and current_splits is not None
            and (sizes is None or saved_mesh == sizes)
            and all(current_splits(k, v) == _splits_of(v) for k, v in layout.items()))
    if same and not via_host:
        return _read_sharded(src, stem, layout, saved, rank), False
    return _read_sharded(src, stem, layout, saved, None, saved_mesh), True


def load_accelerator_state(accelerator, input_dir: Optional[str] = None,
                           load_kwargs: Optional[dict] = None,
                           via_host: Optional[bool] = None) -> str:
    """Restore what :func:`save_accelerator_state` wrote into the prepared
    objects, in place; return the directory read. ``via_host`` forces
    (True) or suppresses (False) the restore through whole tensors; the
    default (None) takes it exactly when ``world.json`` names another
    number of processes. A sharded save whose layout differs from the
    current one is read through whole tensors either way.
    ``load_kwargs`` is taken for the reference's signature (its orbax
    restore arguments); nothing reads it."""
    wait_for_saves(accelerator)  # a background write must be on disk first
    PartialState().wait_for_everyone()  # ... the main process's too
    src = _checkpoint_dir(accelerator, input_dir, for_load=True)
    if not src.exists():
        raise FileNotFoundError(f"Checkpoint directory {src} does not exist")
    state = PartialState()
    rank, world = state.process_index, state.num_processes
    saved = _saved_world(src)
    forced = via_host
    via_host = bool(via_host)
    if forced is None and saved is not None and saved != world:
        via_host = True
        logger.info(f"Checkpoint written by {saved} processes; restoring into {world} "
                    "through whole tensors")

    sizes = _mesh_sizes(accelerator)
    coords = _coords(sizes, rank)
    for i, model in enumerate(accelerator._models):
        stem = _indexed(MODEL_NAME, i)
        dims = _model_layout(model)
        tensors, whole = _restore(src, stem, _read_layout(src, stem), saved, via_host, rank, world,
                                  None if dims is None else
                                  (lambda k, _, d=dims: _splits_of(d.get(k, {}))), sizes)
        if whole and getattr(model, "layout", None) is not None:
            model.layout.load_full(model.module, tensors)
        else:
            model.module.load_state_dict(tensors)

    for i, opt in enumerate(accelerator._optimizers):
        meta_path = src / f"optimizer_meta_{i}.json"
        if not meta_path.exists():
            continue
        meta = json.loads(meta_path.read_text())
        stem = _indexed(OPTIMIZER_NAME, i)
        layouts = opt.param_splits()

        def current_splits(key, entry):
            # A tensor shaped like its whole parameter follows the
            # parameter's splits; the rest (step counts) stay whole.
            splits, whole_shape = layouts[int(key.split(".")[1])]
            return splits if tuple(entry["shape"]) == tuple(whole_shape) else {}

        tensors, whole = _restore(src, stem, meta.get("layout"), saved, via_host, rank, world,
                                  current_splits if opt._chunk_layout else None, sizes)
        if whole and opt._chunk_layout:
            tensors = _chunk_state(opt, tensors, sizes, coords)
        # The tensors were just read from the file, so the optimizer owns
        # them: nothing is shared with another optimizer.
        opt.optimizer.load_state_dict(_join_optimizer_state(tensors, meta))
        if opt.offload_to_host:
            opt._state_to("host")
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


def save_sharded(tensors: dict, save_directory, max_shard_size="10GB"):
    """Write ``{name: tensor}`` as safetensors: one ``model.safetensors`` or,
    past ``max_shard_size``, shards named ``model-0000i-of-0000n`` with
    ``model.safetensors.index.json`` mapping each tensor to its shard."""
    os.makedirs(save_directory, exist_ok=True)
    limit = _parse_size(max_shard_size)
    shards, sizes = [{}], [0]
    for name, t in tensors.items():
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


def save_model(accelerator, model, save_directory: str, max_shard_size="10GB",
               safe_serialization: bool = True):
    """Export the model's state dict as safetensors (:func:`save_sharded`).
    Tied weights (one storage under two names) are written once. Only the
    main process of ``accelerator`` writes (any object with
    ``is_main_process``; None writes), and every process waits for it. A
    model sharded over the process group (FSDP) is gathered whole first,
    by every process."""
    if not safe_serialization:
        raise NotImplementedError("the port writes model files as safetensors only")
    module = getattr(model, "module", model)
    from .parallel.sharding import sharded_layout_of

    layout = getattr(model, "layout", None) or sharded_layout_of(module)
    state = layout.full_state_dict(module) if layout is not None else module.state_dict()
    flat, seen = {}, set()
    for name, t in state.items():
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape))
        if key in seen:
            continue
        seen.add(key)
        flat[name] = t
    if getattr(accelerator, "is_main_process", True):
        save_sharded(flat, save_directory, max_shard_size)
    if hasattr(accelerator, "wait_for_everyone"):
        accelerator.wait_for_everyone()


def merged_model_tensors(checkpoint_dir, index: int = 0) -> dict:
    """Model ``index`` of a ``save_state`` directory as whole tensors by
    name: its ``model.safetensors``, or its processes' chunks put back
    together by its layout."""
    src = Path(checkpoint_dir)
    stem = _indexed(MODEL_NAME, index)
    return _restore(src, stem, _read_layout(src, stem), _saved_world(src), True, 0, 1)[0]


def _export_tensors(save_directory, read=load_safetensors) -> dict:
    """The tensors of a :func:`save_model` export (one file or shards) by
    their dotted names, each file read by ``read(path)``."""
    d = Path(save_directory)
    index_path = d / SAFE_WEIGHTS_INDEX_NAME
    flat: dict = {}
    if index_path.exists():
        index = json.loads(index_path.read_text())
        for name in sorted(set(index["weight_map"].values())):
            flat.update(read(d / name))
    else:
        flat = read(d / SAFE_WEIGHTS_NAME)
    return flat


def load_safetensors_model(save_directory: str, threads: int = 8) -> dict:
    """A model file written by :func:`save_model` (either package's), one or
    sharded, as a nested dict of CPU tensors keyed by the dotted names. Each
    file is read by ``threads`` threads through the native runtime
    (``native/io.py``'s ``fast_load_safetensors``; a Python read where g++
    is missing), or by :func:`load_safetensors` for a dtype it does not
    map."""
    from .native.io import fast_load_safetensors

    def read(path):
        try:
            return fast_load_safetensors(str(path), threads=threads)
        except ValueError:  # a dtype the fast path does not map
            return load_safetensors(path)

    return unflatten_params(_export_tensors(save_directory, read))
