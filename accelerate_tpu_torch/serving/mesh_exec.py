"""Tensor-parallel serving slices: one serving replica on ``tp`` devices.

Counterpart of ``accelerate_tpu/serving/mesh_exec.py``. The JAX package is
a single controller: one Python process drives every chip of a slice, and
this module there only decides where each array lives and re-jits the
engine's three programs with ``in_shardings``/``out_shardings`` (GSPMD
inserts the collectives). The port runs one process per tp index (a
process group, as ``launch`` or torchrun start it):

* **Process layout.** Process ``i`` holds shard ``i`` of every slice, on
  device ``slices[s][i]`` of the :class:`SlicePlan`. Process 0 holds every
  slice's host side: the leader engine (scheduler, admission, prefix cache,
  emitter, stats, tracing), and above the engines the router, supervisor,
  gateway and the fleet-shared prefix cache, so ``ReplicaSet``, failover,
  fencing and ``serve`` keep the JAX package's in-process semantics. Every
  other process runs a follower engine a slice, which runs the leader's
  steps in lockstep and never samples for the host: the row-parallel sums
  give every process the same bits, and the head's logits are gathered
  whole, so each follower's tokens, positions and pages equal the
  leader's.
* **One group a slice.** :meth:`SlicePlan.build_mesh` gives each slice two
  process groups over the same tp ranks: the device group its steps' collectives
  run over (NCCL on the card, gloo on the CPU), and a gloo group for the
  :class:`SliceChannel`. Building them is a collective over the world, so
  every process builds the same slices in the same order.
* **The channel.** Before each step the leader sends a header (which step,
  a bank row, stop, rebuild, close) and the step's static input values;
  the follower copies them into its own static input and runs (on the
  card: replays) the same step. The header's exchange also carries each
  follower's status, so a follower that failed fails the leader's engine
  at its next step.
* **A follower failing inside a step** would leave its leader waiting in
  the step's collectives until the device group's timeout
  (``STEP_TIMEOUT``). Instead it fences the slice's device group
  (:meth:`SliceMesh.fence`): it records the failure in the process
  group's store and closes its end of the group, which fails the
  leader's pending collective at once over gloo; on NCCL the leader's
  watchdog reads the store and aborts its own communicator. The leader's
  step then raises :class:`SliceFollowerError`, its engine dies, and the
  fleet fails the slice's streams over; a rebuild of the slice
  (``ReplicaSet.restart_replica``) renews the device group on the same
  devices (:meth:`SliceMesh.renew_device_group`).
* **Params** take the Megatron layout of ``parallel/sharding.py``
  (:meth:`SliceExec.param_shardings`); :func:`shard_for_serving` cuts a
  whole model (a module, a torch state dict or flax params) into this
  process's shard. The embedding table splits on hidden and the head on
  the vocabulary, as the JAX policy places them; their activations are
  gathered whole (``models/llama.py``).
* **KV cache.** Each K/V leaf splits on its heads axis (:meth:`SliceExec.
  heads_axis`: the K/V heads, or ``head_dim`` when the heads do not
  divide); every per-slot row (positions, tokens, seeds, latches, adapter
  rows) and every page scale stays whole on each process; the draft
  model and its pool stay whole too, and only the verify is split.
* **Adapters.** :meth:`SliceExec.bank_shardings` lays each target's LoRA
  factors out like its base kernel; ``AdapterBank.place`` keeps this
  process's share.
* **Prefix blocks** saved by a slice's chunk step are gathered whole and
  kept on the host, so that a block saved by one slice restores into any
  other (the failover resume path); a paged engine's private cache aliases
  page ids.

At ``tp=1`` no process group is needed: the slice is one device of this
process, and the engine differs from the plain one only by its host
blocks.

``SliceExec.jit`` has no counterpart: the port's steps are fixed-shape
functions captured as CUDA graphs (``graphs.py``), not programs jitted
with shardings.
"""

from __future__ import annotations

import math
import os
import threading
import weakref
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import AxisGroup, Mesh, _world
from ..parallel.sharding import (
    PartitionSpec,
    ShardingRules,
    _dim_of,
    chunk_of,
    infer_param_shardings,
    layout_specs,
    swap_spec,
)
from ..utils.environment import env_var

__all__ = ["SliceChannel", "SliceExec", "SliceMesh", "SlicePlan", "shard_for_serving",
           "validate_serving_mesh"]


def _non_tp_product(mesh) -> int:
    return math.prod(s for ax, s in mesh.shape.items() if ax != "tp")


def validate_serving_mesh(mesh):
    """A serving slice mesh is tensor-parallel only: every non-``tp`` axis
    must be trivial. dp-style replication belongs to a ``ReplicaSet``
    (independent engines), not to one engine's mesh. Raises ``ValueError``
    with the fix spelled out."""
    if "tp" not in mesh.shape:
        raise ValueError(
            f"serving mesh must carry a 'tp' axis (got axes {dict(mesh.shape)}); "
            "build it with SlicePlan.plan(tp=...) or MeshConfig(tp=...)")
    extra = _non_tp_product(mesh)
    if extra != 1:
        raise ValueError(
            "serving engine meshes are tensor-parallel only, but this mesh "
            f"has non-tp extent {extra} ({dict(mesh.shape)}). Use "
            "ReplicaSet.from_mesh(tp=..., num_slices=...) for data-parallel "
            "replicas — each replica is its own tp-only slice.")
    return mesh


def visible_devices() -> list:
    """Every visible card, in index order (empty without one)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class SlicePlan:
    """Disjoint tensor-parallel device slices: ``slices[s]`` is the tuple of
    ``tp`` torch devices backing replica ``s`` (process ``i`` of the slice
    runs on ``slices[s][i]``). Built by :meth:`plan`; each slice's
    :class:`SliceMesh` comes from :meth:`build_mesh`."""

    tp: int
    slices: tuple

    @classmethod
    def plan(cls, tp: int, *, num_slices: Optional[int] = None,
             devices: Optional[Sequence] = None) -> "SlicePlan":
        """Carve ``devices`` (default every visible card) into
        ``num_slices`` groups of ``tp`` consecutive devices;
        ``num_slices`` defaults to every full slice the devices afford.
        ``devices[s*tp:(s+1)*tp]`` is slice ``s``. A CPU run names its
        devices (``["cpu"] * n``)."""
        if tp < 1:
            raise ValueError(f"tp must be >= 1 (got {tp})")
        devices = [torch.device(d) for d in (devices if devices is not None
                                             else visible_devices())]
        afford = len(devices) // tp
        if afford < 1:
            raise ValueError(
                f"tp={tp} needs at least {tp} devices (have {len(devices)})")
        n = afford if num_slices is None else int(num_slices)
        if n < 1 or n > afford:
            raise ValueError(
                f"num_slices={num_slices} out of range: {len(devices)} "
                f"devices afford at most {afford} slices of tp={tp}")
        groups = tuple(tuple(devices[i * tp:(i + 1) * tp]) for i in range(n))
        return cls(tp=tp, slices=groups)

    def __len__(self) -> int:
        return len(self.slices)

    def build_mesh(self, index: int) -> "SliceMesh":
        """Slice ``index``'s tp-only mesh over processes ``0 .. tp-1`` of the
        process group (all axes present, non-tp sizes 1), with the slice's
        own device and channel groups. Above ``tp=1`` this is a collective
        over the world (every process builds the same slices in the same
        order) and the world must hold exactly ``tp`` processes; a group
        that cannot be built raises."""
        return SliceMesh(self.tp, self.slices[index], index)

    def __repr__(self):
        return f"SlicePlan(tp={self.tp}, slices={[[str(d) for d in s] for s in self.slices]})"


#: How long a slice's step collectives wait for a process that neither
#: arrives nor fails (a wedged one): a follower that fails inside a step
#: fences the group at once instead (:meth:`SliceMesh.fence`).
STEP_TIMEOUT = timedelta(seconds=600)

#: How often a slice leader's watchdog reads the store for a follower's
#: failure (NCCL groups only: gloo fails the pending collective itself).
WATCH_INTERVAL_S = 0.05


def _device_group(tp: int):
    """The device group of a slice: ranks ``0 .. tp-1`` on the default
    backend (NCCL on the card, gloo on the CPU)."""
    import torch.distributed as dist

    return dist.new_group(list(range(tp)), timeout=STEP_TIMEOUT)


def _slice_groups(tp: int):
    """A device group and a gloo channel group over ranks ``0 .. tp-1``.
    The channel waits for the leader's next step however long the engine
    idles."""
    import torch.distributed as dist

    device = _device_group(tp)
    host = dist.new_group(list(range(tp)), backend="gloo", timeout=timedelta(days=365))
    return device, host


class _FencedGroup(AxisGroup):
    """The device group of a fenced slice: every collective raises."""

    def _fenced(self, *args, **kwargs):
        raise SliceFollowerError(f"the device group of {self.axes} was fenced after a "
                                 "failure inside a step")

    all_reduce = all_gather = reduce_scatter = all_to_all = broadcast = _fenced


def _join_world(tp: int):
    """``(world, rank)``, joining the process group the environment names
    (``launch``'s or torchrun's) when none is up yet; a slice above ``tp=1``
    needs exactly ``tp`` processes."""
    world, rank = _world()
    named = env_var("COORDINATOR_ADDRESS") in os.environ or "WORLD_SIZE" in os.environ
    if world == 1 and tp > 1 and named:
        import torch.distributed as dist

        if not dist.is_initialized():
            from ..state import PartialState

            PartialState()
            world, rank = _world()
    if tp > 1 and world != tp:
        raise RuntimeError(
            f"a tp={tp} serving slice runs one process per tp index, but the process group "
            f"holds {world} process(es): launch {tp} processes (accelerate-tpu-torch launch "
            f"--num_processes {tp}, or torchrun --nproc-per-node {tp})")
    return world, rank


class SliceMesh(Mesh):
    """One serving slice: a tp-only :class:`~accelerate_tpu_torch.parallel.
    mesh.Mesh` over processes ``0 .. tp-1`` (at ``tp=1``: this process),
    the slice's torch ``devices``, its ``index`` in the plan, and its
    :class:`SliceChannel`. Inside ``with mesh:`` the layers' ``tp`` group
    is the slice's device group."""

    def __init__(self, tp: int, devices: Sequence, index: int = 0):
        world, rank = _join_world(tp)
        ranks = list(range(tp)) if tp > 1 else [rank]
        self.torch_devices = tuple(torch.device(d) for d in devices)
        self.index = int(index)
        # Mesh.__init__ builds no group here: a tp-only mesh's one axis
        # spans the whole world or one process.
        super().__init__({"tp": tp}, ranks, rank)
        self.channel: Optional[SliceChannel] = None
        #: bumped by every renewal of the device group, on every process.
        self.generation = 0
        if tp > 1:
            device, host = _slice_groups(tp)
            self._groups[("tp",)] = AxisGroup(("tp",), ranks, rank, device)
            self.channel = SliceChannel(AxisGroup(("tp",), ranks, rank, host), self.index)
            self._watch()

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    # -- failures inside a step -------------------------------------------
    def _failure_key(self) -> str:
        return f"accelerate_tpu_torch/slice{self.index}/gen{self.generation}/failed"

    @staticmethod
    def _store():
        import torch.distributed as dist

        return dist.distributed_c10d._get_default_store()

    def follower_failed(self) -> bool:
        """Whether a process of this slice fenced its device group (a
        failure inside a step) since the group was last renewed."""
        if self.tp == 1:
            return False
        try:
            return bool(self._store().check([self._failure_key()]))
        except RuntimeError:  # the store is gone: nothing to read
            return False

    def fence(self) -> None:
        """After a failure inside a step (a follower's): record it in the
        process group's store, where the leader's step and watchdog look,
        and close this process's end of the device group, so the leader's
        pending collective fails now (gloo) instead of waiting out
        ``STEP_TIMEOUT``. The slice serves again after a rebuild
        (:meth:`renew_device_group`)."""
        if self.tp == 1:
            return
        self._store().set(self._failure_key(), str(self.rank))
        self._close_device_group()

    def _close_device_group(self) -> None:
        """Close this process's end of the device group. The engine's steps
        hold its :class:`AxisGroup`, which turns fenced in place (every
        collective raises); the torch group, unreferenced once destroyed,
        closes its connections, which gloo's peers see at once."""
        import torch.distributed as dist

        group = self._groups[("tp",)]
        if isinstance(group, _FencedGroup):
            return
        pg, group.group = group.group, None
        group.__class__ = _FencedGroup
        dist.destroy_process_group(pg)

    def renew_device_group(self) -> None:
        """A fresh device group on the slice's processes and devices (every
        process of the slice calls it at the slice's rebuild: building a
        group is a collective over the world); the old one is closed. The
        failure record of the old group's generation stays behind."""
        if self.tp == 1:
            return
        old = self._groups[("tp",)]
        self._close_device_group()
        self.generation += 1
        self._groups[("tp",)] = AxisGroup(("tp",), old.ranks, old.index, _device_group(self.tp))
        self._watch()

    def _watch(self) -> None:
        """On the leader of a slice whose device group is NCCL, a daemon
        thread that aborts this process's communicator when a follower
        fenced the group (NCCL's pending kernels do not notice a peer
        closing its end). It ends with the mesh or at the next renewal."""
        import torch.distributed as dist

        group = self._groups[("tp",)].group
        if self.coords["tp"] != 0 or dist.get_backend(group) != "nccl":
            return
        ref, generation = weakref.ref(self), self.generation

        def watch():
            import time

            while True:
                mesh = ref()
                if mesh is None or mesh.generation != generation:
                    return
                if mesh.follower_failed():
                    try:
                        group.abort()
                    except Exception:
                        pass
                    return
                del mesh
                time.sleep(WATCH_INTERVAL_S)

        threading.Thread(target=watch, name=f"slice-{self.index}-watchdog", daemon=True).start()

    @property
    def device(self) -> torch.device:
        """This process's device in the slice."""
        return self.torch_devices[self.coords["tp"]]

    def __repr__(self):
        return (f"SliceMesh(tp={self.tp}, index={self.index}, "
                f"devices={[str(d) for d in self.torch_devices]}, rank={self.rank})")


# -- the channel ------------------------------------------------------------

#: Header kinds.
STEP, BANK_ROW, STOP, BUILD, CLOSE, SYNC = 1, 2, 3, 4, 5, 6


class SliceFollowerError(RuntimeError):
    """A follower process of a slice failed; the leader's engine dies of it."""


class SliceChannel:
    """The leader-to-followers channel of one slice, over its gloo group.

    Every message starts with one all-reduce of a 6-value header (kind,
    code, payload values, block flag, status, spare): the leader writes the
    fields, each follower only its status (0, or 1 after a failure), so
    one collective hands the followers the header and the leader the
    followers' status. A step's input values (int64) and a prefix block
    (the cache dtype) follow as broadcasts from the leader. ``alive`` drops
    when a follower reported a failure (the leader then sends nothing more
    to the engine it served)."""

    def __init__(self, group: AxisGroup, slice_index: int = 0):
        self.group = group
        self.slice_index = slice_index
        self.leader = group.index == 0
        self.alive = True
        self._header = torch.zeros(6, dtype=torch.int64)
        self._lock = threading.Lock()

    def _exchange(self, kind: int = 0, code: int = 0, n: int = 0, block: int = 0,
                  status: int = 0) -> list:
        h = self._header
        if self.leader:
            h.copy_(torch.tensor([kind, code, n, block, status, 0], dtype=torch.int64))
        else:
            h.zero_()
            h[4] = status
        self.group.all_reduce(h)
        return h.tolist()

    def send(self, kind: int, code: int = 0, payload: Optional[torch.Tensor] = None,
             block: Optional[torch.Tensor] = None):
        """Leader: one message; raises :class:`SliceFollowerError` when a
        follower reports a failure."""
        with self._lock:
            n = 0 if payload is None else payload.numel()
            *_, status, _ = self._exchange(kind, code, n, int(block is not None))
            if status:
                self.alive = False
                raise SliceFollowerError(
                    f"a follower process of serving slice {self.slice_index} failed "
                    "(its error is raised in that process)")
            if payload is not None:
                self.group.broadcast(payload, 0)
            if block is not None:
                self.group.broadcast(block.contiguous(), 0)

    def handshake(self, failed: bool) -> None:
        """Every process, once an engine is built (or failed to): raises on
        every process when any failed."""
        with self._lock:
            *_, status, _ = self._exchange(SYNC, status=int(failed))
        if status and not failed:
            raise SliceFollowerError(
                f"a process of serving slice {self.slice_index} failed to build its engine")
        self.alive = True

    def receive(self, status: int = 0) -> tuple:
        """Follower: the next header ``(kind, code, payload values, block
        flag)``, contributing ``status``."""
        kind, code, n, block, _, _ = self._exchange(status=status)
        return kind, code, n, block

    def receive_into(self, tensor: torch.Tensor) -> torch.Tensor:
        """Follower: a payload or block broadcast by the leader."""
        return self.group.broadcast(tensor, 0)


# -- shardings ---------------------------------------------------------------

#: Where a head-major port K/V leaf or prefix block keeps the axis of the
#: JAX per-slot template ``[1, L, n_kv, hd]`` that :meth:`SliceExec.heads_axis`
#: names: the K/V heads (template axis 2) or head_dim (axis 3).
_KV_DIM = {2: 1, 3: 3}
_BLOCK_DIM = {2: 2, 3: 4}


class SliceExec:
    """Sharding derivation for ONE slice (JAX ``SliceExec``): the slice
    ``mesh``, its width ``tp``, this process's ``index`` and ``device``, the
    device group (``group``: the layers' tp collectives; None at ``tp=1``)
    and the ``channel``. The specs are :class:`~accelerate_tpu_torch.
    parallel.sharding.PartitionSpec` s in the port's layouts (a torch
    ``Linear`` weight is ``[out, in]``); :meth:`place` cuts whole tensors
    into this process's chunks."""

    def __init__(self, mesh):
        validate_serving_mesh(mesh)
        self.mesh = mesh
        self.tp = int(mesh.shape["tp"])
        self.index = int(mesh.coords["tp"]) if mesh.coords is not None else 0
        devices = getattr(mesh, "torch_devices", None)
        self.device = devices[self.index] if devices else None
        self.channel = getattr(mesh, "channel", None)
        #: the replicated spec (scalars, ids, masks, per-slot rows).
        self.replicated = PartitionSpec()

    @property
    def group(self) -> Optional[AxisGroup]:
        return self.mesh.group("tp") if self.tp > 1 else None

    @property
    def leader(self) -> bool:
        return self.index == 0

    # -- params ----------------------------------------------------------
    def param_shardings(self, model: nn.Module) -> dict:
        """``{name: PartitionSpec}`` of ``model``'s parameters under this
        slice's ``tp`` axis: the training rules (``layout_specs`` with a
        tp-size plugin), FSDP off."""
        from ..utils.dataclasses import TensorParallelPlugin

        return layout_specs(model, None, {"tp": self.tp},
                            tp_plugin=TensorParallelPlugin(tp_size=self.tp))

    def kernel_spec(self, name: str, shape: tuple) -> PartitionSpec:
        """The spec of a projection weight ``name`` (``...<proj>.weight``)
        of torch shape ``[out, in]``, by the Megatron rules on its kernel."""
        from ..utils.dataclasses import TensorParallelPlugin

        parts = name.split(".")
        path = "/".join(parts[:-1] + ["kernel"])
        ref = (shape[1], shape[0])
        spec = infer_param_shardings([(path, ref)], {"tp": self.tp},
                                     tp_plugin=TensorParallelPlugin(tp_size=self.tp))[path]
        return swap_spec(spec, 2, True)

    # -- KV cache --------------------------------------------------------
    def heads_axis(self, template_shape: tuple, length_axis: int) -> Optional[int]:
        """The shard axis of one KV leaf, relative to the per-slot template
        (e.g. ``[1, L, n_kv, hd]``): the first non-length axis of extent > 1
        divisible by ``tp`` (the K/V heads, else head_dim). None: the leaf
        replicates."""
        if self.tp == 1:
            return None
        for ax, size in enumerate(template_shape):
            if ax == length_axis:
                continue
            if size > 1 and size % self.tp == 0:
                return ax
        return None

    def cache_leaf_shardings(self, template_shapes, length_axes,
                             with_slot_axis: bool) -> list:
        """One spec a KV leaf of the template's layout (``with_slot_axis``
        prepends the replicated ``[max_slots]`` or pages dimension)."""
        out = []
        for shape, lax in zip(template_shapes, length_axes):
            ax = self.heads_axis(tuple(shape), lax)
            if ax is None:
                out.append(self.replicated)
                continue
            shift = 1 if with_slot_axis else 0
            spec = [None] * (len(shape) + shift)
            spec[ax + shift] = "tp"
            out.append(PartitionSpec(*spec))
        return out

    def state_shardings(self, state: dict, template_shapes, length_axes) -> dict:
        """Specs matching the engine's state dict: the KV subtree (``pool``
        or ``cache``: per layer ``{"k", "v"}``, head-major ``[rows, n_kv, L
        or P, hd]``) split on its heads axis, everything else (positions,
        tokens, seeds, latches, adapter rows, page scales, the draft pool)
        replicated."""
        kv_key = "pool" if "pool" in state else "cache"
        specs = iter([self._port_spec(s, _KV_DIM) for s in self.cache_leaf_shardings(
            template_shapes, length_axes, with_slot_axis=False)])
        out = {}
        for key, value in state.items():
            if key == kv_key:
                out[key] = [{name: next(specs) for name in layer} for layer in value]
            else:
                out[key] = _map(lambda _: self.replicated, value)
        return out

    def block_shardings(self, template_shapes, length_axes) -> PartitionSpec:
        """The spec of one prefix-cache chunk block ``[layers, 2, n_kv, C,
        hd]`` (every layer's leaves alike)."""
        spec = self.cache_leaf_shardings(template_shapes[:1], length_axes[:1], False)[0]
        return self._port_spec(spec, _BLOCK_DIM)

    @staticmethod
    def _port_spec(spec, dims: dict) -> PartitionSpec:
        ax = _dim_of(spec, "tp")
        if ax is None:
            return PartitionSpec()
        axes = [None] * (dims[ax] + 1)
        axes[dims[ax]] = "tp"
        return PartitionSpec(*axes)

    # -- adapter bank ----------------------------------------------------
    def bank_shardings(self, bank) -> dict:
        """Specs of ``bank.stacks`` (``a`` [M, in, R], ``b`` [M, R, out],
        ``scale`` [M]): column targets split ``b``'s ``d_out``, row targets
        ``a``'s ``d_in`` (the ``ShardingRules`` regexes on the base
        kernel); the rest, and any dim the slice does not divide,
        replicates. The bank row axis never splits."""
        rules = ShardingRules()
        out = {}
        for path, leaves in bank.stacks.items():
            tp_dim = rules.tp_dim_for(path.replace(".", "/") + "/kernel")
            a_spec = b_spec = self.replicated
            if tp_dim == -1 and leaves["b"].shape[2] % self.tp == 0:
                b_spec = PartitionSpec(None, None, "tp")
            elif tp_dim == -2 and leaves["a"].shape[1] % self.tp == 0:
                a_spec = PartitionSpec(None, "tp")
            out[path] = {"a": a_spec, "b": b_spec, "scale": self.replicated}
        return out

    # -- placement -------------------------------------------------------
    def place(self, tree, shardings):
        """This process's chunk of every whole tensor of ``tree`` (nested
        dicts and lists) by its spec in ``shardings``, on the slice's
        device."""
        if isinstance(tree, dict):
            return {k: self.place(v, shardings[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place(v, s) for v, s in zip(tree, shardings))
        chunk = chunk_of(tree, _dim_of(shardings, "tp"), self.index, self.tp)
        return chunk.to(self.device if self.device is not None else chunk.device,
                        copy=True).contiguous()

    def per_chip_bytes(self, tree) -> int:
        """Bytes of ``tree`` (nested dicts and lists of this process's
        tensors) on this process's device: each leaf's shard, the largest
        of the slice's for the even splits the specs make."""
        return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# -- the weight bridge --------------------------------------------------------

#: Serving shards already cut from a whole module: (tp, index, device,
#: weights dtype) -> shard, per source module, so that slices on one device
#: (a fleet on one card, or every slice on this process's CPU) share one
#: copy of the weights.
_SHARDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SHARDS_LOCK = threading.Lock()


def shard_for_serving(source, exec_: SliceExec, *, config=None, weights_dtype=None,
                      dtype=None) -> nn.Module:
    """This process's serving shard of a whole Llama: ``source`` is a
    ``LlamaForCausalLM`` (any device), a torch state dict, or flax params
    (``config`` names the model for the last two). ``weights_dtype="int8"``
    quantizes the whole model first, then cuts it
    (``adapters.shardings_for_quantized``). A state dict or flax params is
    loaded into a skeleton built on the meta device, so only this shard
    reaches the slice's device. At ``tp=1`` a module serves as it is (an
    int8 copy once a device). A shard this function made (marked
    ``_serving_slice``) serves its own slice as it is, and no other."""
    from ..adapters.quantize import quantize_base_weights, shardings_for_quantized

    key = (exec_.tp, exec_.index, str(exec_.device), weights_dtype)
    made = getattr(source, "_serving_slice", None)
    if made is not None:
        if made != key:
            raise ValueError(f"a serving shard cut for (tp, index, device, weights) {made} "
                             f"cannot serve {key}; pass the whole model")
        return source
    if not isinstance(source, nn.Module):
        from ..models.llama import LlamaForCausalLM
        from ..utils.convert import state_dict_from_flax

        if config is None:
            raise ValueError("shard_for_serving needs config= for a state dict or flax params")
        state = source
        if not all(isinstance(v, torch.Tensor) for v in state.values()):
            state = state_dict_from_flax(state, config)
        if dtype is not None:
            state = {k: v.to(dtype) for k, v in state.items()}
        if weights_dtype is None:
            with torch.device("meta"):
                skeleton = LlamaForCausalLM(config, dtype=dtype or torch.float32)
            specs = exec_.param_shardings(skeleton)
            missing = set(specs) - set(state)
            if missing:
                raise ValueError(f"the state dict lacks {sorted(missing)[:4]}")
            for name, value in state.items():
                owner_name, _, leaf = name.rpartition(".")
                owner = skeleton.get_submodule(owner_name)
                owner._parameters[leaf] = nn.Parameter(
                    exec_.place(value, specs.get(name, PartitionSpec())), requires_grad=False)
            skeleton._serving_slice = key
            return skeleton.eval()
        whole = LlamaForCausalLM(config, device="cpu", dtype=dtype or torch.float32)
        whole.load_state_dict(state)
        # Quantized whole (on the host), then cut; at tp=1 the copy serves.
        source = whole if exec_.tp > 1 else whole.to(exec_.device)
    if exec_.tp == 1 and weights_dtype is None:
        return source
    with _SHARDS_LOCK:
        cached = _SHARDS.setdefault(source, {})
        if key in cached:
            return cached[key]
        module = quantize_base_weights(source) if weights_dtype == "int8" else source
        if exec_.tp > 1:
            specs = (shardings_for_quantized(exec_, module) if weights_dtype == "int8"
                     else exec_.param_shardings(module))
            module = _cut(module, specs, exec_, "")
        module._serving_slice = key
        cached[key] = module
        return module


@torch.no_grad()
def _cut(module: nn.Module, specs: dict, exec_: SliceExec, prefix: str) -> nn.Module:
    """A structural copy of ``module`` whose parameters and buffers are this
    process's chunks (new tensors on the slice's device; ``module`` is left
    as it was)."""
    import copy

    new = copy.copy(module)
    new._parameters = {
        name: None if p is None else nn.Parameter(
            exec_.place(p.detach(), specs.get(prefix + name, PartitionSpec())),
            requires_grad=False)
        for name, p in module._parameters.items()}
    new._buffers = {
        name: None if b is None else exec_.place(b, specs.get(prefix + name, PartitionSpec()))
        for name, b in module._buffers.items()}
    new._modules = {name: None if child is None else _cut(child, specs, exec_,
                                                          f"{prefix}{name}.")
                    for name, child in module._modules.items()}
    return new
