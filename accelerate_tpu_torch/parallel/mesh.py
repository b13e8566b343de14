"""Device meshes over the process group.

Counterpart of ``accelerate_tpu/parallel/mesh.py``. The JAX package lays
its devices out as a ``jax.sharding.Mesh`` with named axes and leaves the
collectives over an axis to XLA. Here each process is one device of the
mesh: :meth:`MeshConfig.build` lays the processes of the group out
row-major over the axes in the order ``("pp", "dp", "fsdp", "ep", "cp",
"tp")`` (``tp`` innermost), the order the JAX package gives its devices
on a GPU or the CPU, so process ``r`` holds what the JAX package's device
``r`` holds. Placement on a TPU torus (``dcn_axis``,
``allow_split_physical_axes``) has no counterpart: the fields are kept and
read by nothing.

A :class:`Mesh` knows this process's coordinates, and for any set of
axes the processes that differ from it only along those axes
(:meth:`Mesh.group`, an :class:`AxisGroup`): a torch process group with
the collectives the parallel layers run over it. A group of one process
communicates nothing, so a mesh of axes of size 1 runs every layer's
collectives as the identity.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.constants import BATCH_AXES, MESH_AXES
from ..utils.environment import env_var

#: Row-major order of the axes over the processes: dp outermost of the data
#: axes, tp innermost (the JAX package's ``MeshConfig.build``).
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "cp", "tp")

#: The axes whose processes see different data: gradients are summed over
#: them. Over ``tp`` and ``pp`` a leaf is either split or replicated with
#: equal gradients on every process.
DATA_AXES = ("dp", "fsdp", "cp")

# Groups built with the mesh (when above one process and below the world):
# the ones every training step uses.
_STANDARD_GROUPS = (("dp",), ("fsdp",), ("cp",), ("tp",), ("pp",), ("ep",), ("dp", "fsdp"),
                    ("dp", "cp"), ("fsdp", "cp"), ("dp", "fsdp", "cp"), ("dp", "fsdp", "ep"),
                    ("dp", "fsdp", "ep", "cp", "tp"))  # the last: fp8 statistics' commit


@dataclass
class MeshConfig:
    """Declarative mesh shape over the canonical axes.

    One axis set to -1 absorbs the processes the others leave (at most one
    -1); with none, ``dp`` absorbs the remainder when the product of the
    axes divides the process count. Axes of size 1 stay in the mesh.
    ``zero_sharding`` shards the AdamW moments over ``dp`` (else ``fsdp``),
    as the FSDP plugin's does; ``ACCELERATE_TPU_MESH_ZERO_SHARDING=1`` sets
    it. ``devices``: the processes' ranks, default every process of the
    group. ``dcn_axis`` and ``allow_split_physical_axes`` place axes on a
    TPU torus and are read by nothing here."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    cp: int = 1
    ep: int = 1
    pp: int = 1
    dcn_axis: str = "dp"
    devices: Optional[Sequence] = None
    allow_split_physical_axes: bool = True
    zero_sharding: bool = False

    @classmethod
    def from_env(cls) -> "MeshConfig":
        """From the ``ACCELERATE_TPU_MESH_*`` variables the launcher sets."""
        kwargs = {}
        for ax in MESH_AXES:
            v = os.environ.get(env_var(f"MESH_{ax.upper()}"))
            if v is not None:
                kwargs[ax] = int(v)
        if env_var("MESH_DCN_AXIS") in os.environ:
            kwargs["dcn_axis"] = os.environ[env_var("MESH_DCN_AXIS")]
        v = os.environ.get(env_var("MESH_ZERO_SHARDING"))
        if v is not None:
            kwargs["zero_sharding"] = v.lower() not in ("0", "false", "")
        if "dp" not in kwargs and -1 in (kwargs.get(ax) for ax in MESH_AXES if ax != "dp"):
            kwargs["dp"] = 1  # the launcher's -1 axis takes what dp would
        return cls(**kwargs)

    def axis_sizes(self, num_devices: int) -> dict:
        """The axis sizes over ``num_devices`` processes, -1 resolved."""
        sizes = {ax: getattr(self, ax) for ax in MESH_AXES}
        unknown = [ax for ax, s in sizes.items() if s == -1]
        known = math.prod(s for s in sizes.values() if s != -1)
        if len(unknown) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {unknown}")
        if unknown:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by explicit axes product {known} "
                    f"({ {ax: s for ax, s in sizes.items() if s != -1} })")
            sizes[unknown[0]] = num_devices // known
        else:
            total = math.prod(sizes.values())
            if total != num_devices:
                if num_devices % total == 0:
                    sizes["dp"] *= num_devices // total
                else:
                    raise ValueError(
                        f"Mesh axes product {total} does not divide device count {num_devices}")
        return sizes

    def build(self, devices: Optional[Sequence] = None) -> "Mesh":
        """The :class:`Mesh` of this config over ``devices`` (process ranks;
        default ``self.devices``, else every process of the group). Its
        groups are built here, by every process of the group at once."""
        world, rank = _world()
        devices = list(devices if devices is not None
                       else (self.devices if self.devices is not None else range(world)))
        if self.dcn_axis not in MESH_AXES:
            raise ValueError(f"dcn_axis must be one of {MESH_AXES}, got {self.dcn_axis!r}")
        return Mesh(self.axis_sizes(len(devices)), devices, rank)

    def non_trivial_axes(self) -> dict:
        return {ax: getattr(self, ax) for ax in MESH_AXES if getattr(self, ax) not in (1,)}

    def __str__(self):
        parts = ", ".join(f"{ax}={getattr(self, ax)}" for ax in MESH_AXES)
        return f"MeshConfig({parts})"


def _world() -> tuple:
    """``(world size, this rank)`` of the process group, ``(1, 0)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _single(name: str, legacy: str):
    """``torch.distributed``'s ``*_single`` collective, or its older name
    (which newer torch keeps, deprecated)."""
    import torch.distributed as dist

    return getattr(dist, name, None) or getattr(dist, legacy)


class AxisGroup:
    """The processes that differ from this one only along ``axes``, in
    row-major order over those axes (``ranks``, global ranks), this
    process's ``index`` among them, and their torch process group
    (``group``; None is the whole world). A group of one process
    (``size == 1``) communicates nothing: every collective returns its
    input."""

    def __init__(self, axes: tuple, ranks: list, index: int, group=None):
        self.axes = tuple(axes)
        self.ranks = list(ranks)
        self.index = index
        self.group = group
        self.size = len(self.ranks)

    def __repr__(self):
        return f"AxisGroup(axes={self.axes}, ranks={self.ranks}, index={self.index})"

    # -- collectives (tensors where the backend moves them: the card for
    # NCCL, the CPU for gloo) ----------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or, with ``op="max"``, the maximum) over the group, in
        place."""
        if self.size > 1:
            import torch.distributed as dist

            reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            dist.all_reduce(t, op=reduce_op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's ``t`` concatenated along ``dim`` in group order."""
        if self.size == 1:
            return t
        flat = t.contiguous()
        out = torch.empty((self.size * flat.numel(),), dtype=t.dtype, device=t.device)
        _single("all_gather_single", "all_gather_into_tensor")(out, flat.reshape(-1),
                                                                group=self.group)
        parts = out.view(self.size, *t.shape).unbind(0)
        return torch.cat(parts, dim=dim) if dim != 0 else out.view(self.size * t.shape[0],
                                                                   *t.shape[1:])

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This process's chunk along ``dim`` of the sum over the group."""
        if self.size == 1:
            return t
        rows = torch.stack(t.chunk(self.size, dim=dim)).contiguous()
        out = torch.empty(rows.shape[1:], dtype=t.dtype, device=t.device)
        _single("reduce_scatter_single", "reduce_scatter_tensor")(
            out.view(-1), rows.view(-1), group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """``t`` split along ``split_dim`` into one piece a process; piece
        ``j`` goes to process ``j``, and the pieces received are
        concatenated along ``concat_dim`` in group order (the JAX package's
        tiled ``all_to_all``)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        send = torch.stack(t.chunk(self.size, dim=split_dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return torch.cat(recv.unbind(0), dim=concat_dim)

    def broadcast(self, t: torch.Tensor, src_index: int) -> torch.Tensor:
        """``t`` of the group's process ``src_index``, in place."""
        if self.size > 1:
            import torch.distributed as dist

            dist.broadcast(t, src=self.ranks[src_index], group=self.group)
        return t

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """The ``t`` of the process ``offset`` places before this one in
        the group, around the ring; this ``t`` goes ``offset`` places on
        (one send and one receive, posted together)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        out = torch.empty_like(t)
        dst = self.ranks[(self.index + offset) % self.size]
        src = self.ranks[(self.index - offset) % self.size]
        works = [dist.isend(t, dst), dist.irecv(out, src)]
        for w in works:
            w.wait()
        return out

    def send(self, t: torch.Tensor, index: int):
        """Send ``t`` to the group's process ``index`` (blocking)."""
        import torch.distributed as dist

        dist.send(t.contiguous(), self.ranks[index])

    def recv(self, shape, dtype, device, index: int) -> torch.Tensor:
        """A tensor of ``shape`` from the group's process ``index``."""
        import torch.distributed as dist

        out = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(out, self.ranks[index])
        return out


class Mesh:
    """The processes laid out over the named axes (``shape``, a dict in
    the axis order, like ``jax.sharding.Mesh.shape``; ``devices``, the
    ranks as an array of that shape), this process's place in it
    (``rank``, ``coords``) and its groups (:meth:`group`). Usable as a
    context manager: inside ``with mesh:`` the mesh is
    ``state.current_mesh()``'s."""

    axis_names = AXIS_ORDER

    def __init__(self, sizes: dict, devices: Sequence, rank: int = 0):
        self.shape = {ax: int(sizes.get(ax, 1)) for ax in AXIS_ORDER}
        if math.prod(self.shape.values()) != len(devices):
            raise ValueError(f"mesh {self.shape} does not cover {len(devices)} devices")
        self.devices = np.asarray(list(devices)).reshape(tuple(self.shape.values()))
        self.rank = rank
        where = np.argwhere(self.devices == rank)
        self._position = tuple(int(i) for i in where[0]) if len(where) else None
        self.coords = (dict(zip(AXIS_ORDER, self._position)) if self._position is not None
                       else None)
        self._groups: dict = {}
        world, _ = _world()
        if world > 1 and self.coords is not None and len(devices) == world:
            for axes in _STANDARD_GROUPS:
                size = self.size(axes)
                if 1 < size < world:
                    self.group(*axes)

    @property
    def size_total(self) -> int:
        return int(self.devices.size)

    def size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[ax] for ax in axes)

    def index(self, axes) -> int:
        """This process's row-major index over ``axes`` (in mesh order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = 0
        for ax in AXIS_ORDER:
            if ax in axes:
                out = out * self.shape[ax] + self.coords[ax]
        return out

    def group(self, *axes) -> AxisGroup:
        """The :class:`AxisGroup` of ``axes`` for this process. Building a
        group of more than one process and fewer than all is a collective
        over the whole world: every process asks for it at once (the
        groups of every training step are built with the mesh)."""
        key = tuple(ax for ax in AXIS_ORDER if ax in axes)
        if key in self._groups:
            return self._groups[key]
        if self.coords is None:
            raise RuntimeError(f"process {self.rank} is not in the mesh {self.shape}")
        rows = self.groups_of(*key)
        mine = next(r for r in rows if self.rank in r)
        size = len(mine)
        group = None
        world, _ = _world()
        if size > 1:
            if self.size_total != world:
                raise RuntimeError(f"the mesh {self.shape} covers {self.size_total} of the "
                                   f"{world} processes: it has no collectives")
            if size < world:
                import torch.distributed as dist

                group, _ = dist.new_subgroups_by_enumeration([sorted(r) for r in rows])
        out = AxisGroup(key, mine, mine.index(self.rank), group)
        self._groups[key] = out
        return out

    def groups_of(self, *axes) -> list:
        """Every group of ``axes``: the ranks of each set of processes that
        differ only along those axes, in row-major order over them (no
        communication)."""
        key = tuple(ax for ax in AXIS_ORDER if ax in axes)
        # Move the group's axes last: each row of the reshaped ranks is a group.
        rest = [i for i, ax in enumerate(AXIS_ORDER) if ax not in key]
        own = [i for i, ax in enumerate(AXIS_ORDER) if ax in key]
        return np.transpose(self.devices, rest + own).reshape(-1, self.size(key) or 1).tolist()

    def data_index(self) -> int:
        """This process's data shard: its index over the batch axes."""
        return self.index(tuple(ax for ax in BATCH_AXES if ax in self.shape))

    def data_shards(self) -> int:
        """How many ways the rows of a global batch are split."""
        return mesh_batch_size_multiple(self)

    # -- the ambient mesh -------------------------------------------------

    def __enter__(self):
        _ambient.stack = getattr(_ambient, "stack", []) + [self]
        return self

    def __exit__(self, *exc):
        _ambient.stack = _ambient.stack[:-1]
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


_ambient = threading.local()


def entered_mesh() -> Optional[Mesh]:
    """The innermost mesh of a ``with mesh:`` block on this thread."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


def make_mesh(config: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """A mesh from ``config`` (default: every process on ``dp``)."""
    return (config or MeshConfig()).build(devices=devices)


def mesh_batch_size_multiple(mesh) -> int:
    """How many ways a global batch's rows are split: the product of the
    batch axes."""
    return math.prod(mesh.shape[ax] for ax in BATCH_AXES if ax in mesh.shape)


def axis_group(axis: str, mesh=None) -> Optional[AxisGroup]:
    """The group of ``axis`` in ``mesh`` (default ``current_mesh()``)
    when that axis spans more than one process, else None."""
    if mesh is None:
        from ..state import current_mesh

        mesh = current_mesh()
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None
    return mesh.group(axis)
