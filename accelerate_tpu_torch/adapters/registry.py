"""AdapterBank: many LoRA adapters on the card as one stacked set of tensors.

Counterpart of ``accelerate_tpu/adapters/registry.py``. The bank holds
``max_adapters`` rank-padded adapters stacked on a leading axis (``a``
[M, in, R], ``b`` [M, R, out], ``scale`` [M] per adapted projection), so a
serving step gathers each row's adapter with an index: which adapter a
slot decodes under is data, not a shape. Row 0 is the identity (all zero)
for base-model requests: its delta is exactly 0.

The host side is a named registry with LRU residency: ``acquire`` pins a
named adapter into a row, loading it (and evicting an unpinned one) when it
is not resident; ``release`` unpins it when its request retires. A row is
loaded by an in-place ``copy_`` into the bank's tensors, never by new
tensors: the serving engine's CUDA graphs read the bank's storage, so a
reassigned tensor would leave them reading the old one. ``acquire`` runs on
the engine's thread, whose current stream is the engine's, so the copy is
ordered before the next step it launches. The bookkeeping is under a lock:
``register`` and the lookups come from callers' threads.

On a tensor-parallel serving slice (:meth:`AdapterBank.place`) each stack
holds this process's share, laid out like its base projection (JAX
``SliceExec.bank_shardings``), and a row load writes the share of the host
row; the slice's other processes get the whole row from the engine and
write theirs (``serving/mesh_exec.py``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import torch

from .lora import LoRAConfig, _shapes, adapter_module_paths, adapter_rank, pad_adapter, target_paths


class UnknownAdapterError(LookupError):
    """A request names an adapter nobody registered."""


class AdapterBankFull(RuntimeError):
    """Every bank row is pinned by a request in flight; retry later. The
    request fails with it; the engine stays healthy."""


class AdapterBank:
    """Fixed-shape bank of adapters on the model's device and the host
    registry of named adapters."""

    def __init__(self, model, *, config: Optional[LoRAConfig] = None, max_adapters: int = 8,
                 dtype=torch.float32):
        if max_adapters < 2:
            raise ValueError(f"max_adapters must be >= 2 (row 0 is the reserved identity "
                             f"adapter; got {max_adapters})")
        module = getattr(model, "module", model)
        self.config = config or LoRAConfig()
        self.max_adapters = int(max_adapters)
        self.rank = int(self.config.rank)
        self.device = next(module.parameters()).device
        self._lock = threading.Lock()
        self._paths = target_paths(module, self.config)
        shapes = _shapes(module)
        self._shapes = {p: shapes[p] for p in self._paths}
        M, R = self.max_adapters, self.rank
        self.stacks = {p: {"a": torch.zeros((M, d_in, R), dtype=dtype, device=self.device),
                           "b": torch.zeros((M, R, d_out), dtype=dtype, device=self.device),
                           "scale": torch.zeros((M,), dtype=dtype, device=self.device)}
                       for p, (d_in, d_out) in self._shapes.items()}
        self._registered: dict = {}            # name -> padded host adapter
        self._rows: dict = {}                  # resident name -> row
        self._row_of: list = [None] * M        # row -> name (None = free)
        self._lru: OrderedDict = OrderedDict()  # resident names, LRU first
        self._pins: dict = {}                  # name -> requests in flight
        self.loads = 0
        self.evictions = 0
        #: the serving slice the bank is placed on (None: whole, one device),
        #: each leaf's split dim there, and the hook that sends a loaded
        #: row to the slice's other processes.
        self._placed_mesh = None
        self._exec = None
        self._dims: dict = {}
        self.row_listener = None

    def _identity(self) -> dict:
        return {p: {"a": torch.zeros((d_in, self.rank)), "b": torch.zeros((self.rank, d_out)),
                    "scale": torch.zeros(())}
                for p, (d_in, d_out) in self._shapes.items()}

    @property
    def capacity(self) -> int:
        """Rows available to named adapters (row 0 is reserved)."""
        return self.max_adapters - 1

    def register(self, name: str, adapter: dict, *, allow_update: bool = False) -> None:
        """Add a named adapter to the host registry (its row loads lazily).
        It may adapt any subset of the bank's projections at any rank up to
        the bank's: missing modules are zero deltas, lower ranks are
        zero-padded."""
        if not name or not isinstance(name, str):
            raise ValueError(f"adapter name must be a non-empty string (got {name!r})")
        r = adapter_rank(adapter)
        if r > self.rank:
            raise ValueError(f"adapter {name!r} has rank {r} > bank rank {self.rank}")
        padded = pad_adapter(adapter, self.rank)
        host = self._identity()
        for dotted in adapter_module_paths(padded):
            if dotted not in self._shapes:
                raise ValueError(f"adapter {name!r} targets {dotted!r}, which is not a bank "
                                 f"target (bank targets: {self._paths})")
            mod = padded[dotted]
            d_in, d_out = self._shapes[dotted]
            got = (tuple(mod["a"].shape), tuple(mod["b"].shape))
            want = ((d_in, self.rank), (self.rank, d_out))
            if got != want:
                raise ValueError(f"adapter {name!r} module {dotted!r} has shapes {got}, "
                                 f"expected {want}")
            host[dotted] = {k: mod[k].detach().to("cpu", torch.float32).clone()
                            for k in ("a", "b", "scale")}
        with self._lock:
            if name in self._registered and not allow_update:
                raise ValueError(f"adapter {name!r} is already registered "
                                 "(pass allow_update=True to replace it)")
            if self._pins.get(name, 0) > 0:
                raise RuntimeError(f"adapter {name!r} has in-flight requests; cannot replace")
            row = self._rows.pop(name, None)   # stale residency: reload the new bytes
            if row is not None:
                self._row_of[row] = None
                self._lru.pop(name, None)
            self._registered[name] = host

    def unregister(self, name: str) -> None:
        with self._lock:
            if name not in self._registered:
                raise UnknownAdapterError(name)
            if self._pins.get(name, 0) > 0:
                raise RuntimeError(f"adapter {name!r} has in-flight requests; cannot unregister")
            del self._registered[name]
            row = self._rows.pop(name, None)
            if row is not None:
                self._row_of[row] = None
                self._lru.pop(name, None)

    def names(self) -> list:
        with self._lock:
            return sorted(self._registered)

    def resident(self, name: str) -> bool:
        with self._lock:
            return name in self._rows

    def check_known(self, name: str) -> None:
        with self._lock:
            if name not in self._registered:
                raise UnknownAdapterError(
                    f"unknown adapter {name!r} (registered: {sorted(self._registered)})")

    def gather(self, rows: torch.Tensor) -> dict:
        """The adapters of bank rows ``rows`` [B], stacked per projection
        (``a`` [B, in, R], ``b`` [B, R, out], ``scale`` [B]): the ``lora=``
        argument of a forward whose row ``b`` decodes under adapter
        ``rows[b]``."""
        return {p: {k: v.index_select(0, rows) for k, v in leaves.items()}
                for p, leaves in self.stacks.items()}

    def place(self, exec_) -> None:
        """Shard the bank across a serving slice (JAX ``:106-140``):
        ``exec_`` is the slice's :class:`~accelerate_tpu_torch.serving.
        mesh_exec.SliceExec`, whose ``bank_shardings`` lay each target's
        factors out like its base kernel (column targets split ``b`` on
        ``d_out``, row targets ``a`` on ``d_in``; the row axis never
        splits). The stacks become this process's share on the slice's
        device; later row loads write the share of each row. Engine
        construction time only, and once a bank: a bank placed on one
        slice cannot serve another."""
        from ..parallel.sharding import _dim_of, chunk_of

        with self._lock:
            if self._placed_mesh is not None and self._placed_mesh is not exec_.mesh:
                raise ValueError(
                    "AdapterBank is already placed on another mesh slice; each mesh-sliced "
                    "engine needs its OWN bank (pass a make_adapters factory to "
                    "ReplicaSet.from_mesh)")
            if self._placed_mesh is exec_.mesh:
                return
            specs = exec_.bank_shardings(self)
            self._dims = {p: {k: _dim_of(spec, "tp") for k, spec in leaves.items()}
                          for p, leaves in specs.items()}
            self.stacks = {
                p: {k: chunk_of(v, self._dims[p][k], exec_.index, exec_.tp).to(
                    exec_.device, copy=True).contiguous() for k, v in leaves.items()}
                for p, leaves in self.stacks.items()}
            self.device = exec_.device
            self._exec = exec_
            self._placed_mesh = exec_.mesh

    def _write_row(self, row: int, host: dict) -> None:
        self.write_row(row, host)
        if self.row_listener is not None:
            self.row_listener(row, host)

    def write_row(self, row: int, host: dict) -> None:
        """Write the whole host row ``host`` (this process's share of it,
        on a slice) into bank row ``row``."""
        from ..parallel.sharding import chunk_of

        for p, leaves in self.stacks.items():
            for k, v in leaves.items():
                src = host[p][k]
                if self._exec is not None:
                    dim = self._dims[p][k]
                    src = chunk_of(src, None if dim is None else dim - 1, self._exec.index,
                                   self._exec.tp)
                v[row].copy_(src)

    def row_vector(self, host: dict) -> torch.Tensor:
        """A whole host row as one f32 vector (the bank's targets in order,
        ``a``, ``b`` and ``scale`` of each)."""
        return torch.cat([host[p][k].reshape(-1).to(torch.float32)
                          for p in self._paths for k in ("a", "b", "scale")])

    def row_from_vector(self, flat: torch.Tensor) -> dict:
        """The host row :meth:`row_vector` packed."""
        host, at = {}, 0
        for p in self._paths:
            d_in, d_out = self._shapes[p]
            host[p] = {}
            for k, shape in (("a", (d_in, self.rank)), ("b", (self.rank, d_out)),
                             ("scale", ())):
                n = int(torch.Size(shape).numel())
                host[p][k] = flat[at:at + n].view(shape)
                at += n
        return host

    @property
    def row_size(self) -> int:
        """Elements of :meth:`row_vector`."""
        return sum(self.rank * (d_in + d_out) + 1 for d_in, d_out in self._shapes.values())

    def acquire(self, name: str):
        """Pin ``name`` into a bank row, loading it (and evicting the least
        recently used unpinned adapter) when it is not resident. Returns
        ``(row, hit, evicted name or None)``; raises
        :class:`UnknownAdapterError` for an unregistered name and
        :class:`AdapterBankFull` when every row is pinned."""
        with self._lock:
            if name not in self._registered:
                raise UnknownAdapterError(
                    f"unknown adapter {name!r} (registered: {sorted(self._registered)})")
            if name in self._rows:
                self._lru.move_to_end(name)
                self._pins[name] = self._pins.get(name, 0) + 1
                return self._rows[name], True, None
            evicted = None
            row = next((i for i in range(1, self.max_adapters) if self._row_of[i] is None), None)
            if row is None:
                evicted = next((c for c in self._lru if self._pins.get(c, 0) == 0), None)
                if evicted is None:
                    raise AdapterBankFull(
                        f"all {self.capacity} adapter rows are pinned by in-flight requests; "
                        f"retry adapter {name!r} later")
                row = self._rows.pop(evicted)
                self._lru.pop(evicted)
                self._row_of[row] = None
                self.evictions += 1
            self._write_row(row, self._registered[name])
            self._rows[name] = row
            self._row_of[row] = name
            self._lru[name] = None
            self._pins[name] = self._pins.get(name, 0) + 1
            self.loads += 1
            return row, False, evicted

    def release(self, name: str) -> None:
        with self._lock:
            n = self._pins.get(name, 0)
            if n <= 1:
                self._pins.pop(name, None)
            else:
                self._pins[name] = n - 1

    def counters(self) -> dict:
        with self._lock:
            return {"registered": len(self._registered), "resident": len(self._rows),
                    "capacity": self.capacity, "loads": self.loads,
                    "evictions": self.evictions}
