"""Size accounting, memory budgets and the device-map solver.

Counterpart of ``accelerate_tpu/utils/modeling.py``. There a "model" is an
abstract flax parameter tree; here it is an ``nn.Module`` (on the meta
device, where building it costs no memory), a flat ``{dotted name: tensor}``
state dict, or a nested dict of tensors. A "module" is a dotted name
prefix into it (``model.layers.3.self_attn``). Names are ordered as the JAX
package orders its tree, by natural key at each level (``layers.2`` before
``layers.10``, ``lm_head`` before ``model``), so the solver visits the same
units in the same order and gives the same map, up to the names
(``layers_<i>`` there, ``layers.<i>`` here; ``kernel``/``embedding`` there,
``weight`` here).

Devices in a device map are CUDA device indices (ints), ``"cpu"`` (host
memory) or ``"disk"``: card, host and disk tiers.
"""

from __future__ import annotations

import math
import os
import re
from collections import OrderedDict
from typing import Optional, Union

import torch
from torch import nn

DeviceId = Union[int, str]

_SUB_BYTE = {"int4": 0.5, "int2": 0.25}


def _natural_key(name: str):
    """Sort ``layers_2`` before ``layers_10`` (execution order, not lexical)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _name_key(name: str):
    return [_natural_key(part) for part in name.split(".")]


def parse_size(size: Union[int, float, str]) -> int:
    """``"10GB"``/``"512MiB"``-style strings (binary units) to bytes."""
    if isinstance(size, (int, float)):
        return int(size)
    s = size.strip().upper().replace("IB", "B")
    units = {"TB": 2**40, "GB": 2**30, "MB": 2**20, "KB": 2**10, "B": 1}
    for suffix, mult in units.items():
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(float(s))


def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch dtype or a dtype name, sub-byte ones
    (``"int4"``, ``"int2"``) included."""
    if isinstance(dtype, str):
        if dtype in _SUB_BYTE:
            return _SUB_BYTE[dtype]
        if dtype in ("fp8", "float8_e4m3fn", "float8_e5m2"):
            return 1.0
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def named_parameters(tree, prefix: str = "") -> "OrderedDict[str, torch.Tensor]":
    """``{dotted name: tensor}`` of a module, a state dict or a nested dict,
    in natural order."""
    if isinstance(tree, nn.Module):
        flat = dict(tree.named_parameters())
    else:
        flat = {}

        def walk(node, path):
            for key, value in node.items():
                name = f"{path}{key}"
                if isinstance(value, dict):
                    walk(value, name + ".")
                else:
                    flat[name] = value

        walk(tree, "")
    if prefix:
        flat = {f"{prefix}{k}": v for k, v in flat.items()}
    return OrderedDict(sorted(flat.items(), key=lambda kv: _name_key(kv[0])))


def _leaf_bytes(leaf, dtype=None) -> int:
    n = math.prod(leaf.shape)
    return int(math.ceil(n * dtype_byte_size(dtype if dtype is not None else leaf.dtype)))


def compute_module_sizes(tree, dtype=None, prefix: str = "") -> dict:
    """Byte size of every name prefix, ``""`` for the total. ``dtype``
    overrides the tensors' own (a planned cast). ``prefix`` is taken for
    the reference's signature and, as there, changes nothing."""
    sizes: dict = {}
    for name, leaf in named_parameters(tree).items():
        nbytes = _leaf_bytes(leaf, dtype)
        parts = name.split(".")
        for i in range(len(parts) + 1):
            key = ".".join(parts[:i])
            sizes[key] = sizes.get(key, 0) + nbytes
    return sizes


def calculate_maximum_sizes(tree, no_split: Optional[list] = None, dtype=None):
    """``(total_size, (largest_unit_size, largest_unit_name))``."""
    sizes = compute_module_sizes(tree, dtype=dtype)
    largest = ("", 0)
    for name, prefixes in _split_units(tree, no_split or []):
        size = sum(sizes.get(p, 0) for p in prefixes)
        if size > largest[1]:
            largest = (name, size)
    return sizes.get("", 0), (largest[1], largest[0])


def _host_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 8 << 30


def get_max_memory(max_memory: Optional[dict] = None) -> "OrderedDict[DeviceId, int]":
    """Budget per tier: one entry per CUDA device, then ``"cpu"`` and
    ``"disk"``.

    A budget the caller gives may use ``"10GB"`` strings. Its integer keys
    are the whole device set, taken as they are (the caller names the
    devices, so a CPU run can plan a card tier; a budget with none plans no
    card tier). Without a budget, each visible
    card gets its free memory (``torch.cuda.mem_get_info``) less 10 % of
    headroom for the allocator's scratch, as the JAX package keeps for XLA's.
    Host memory is 80 % of ``MemAvailable``; disk is unbounded."""
    user = {k: parse_size(v) for k, v in (max_memory or {}).items()}
    out: "OrderedDict[DeviceId, int]" = OrderedDict()
    if user:
        for i in sorted(k for k in user if isinstance(k, int)):
            out[i] = user[i]
    elif torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, _ = torch.cuda.mem_get_info(i)
            out[i] = int(free * 0.9)
    out["cpu"] = user.get("cpu", int(_host_memory_bytes() * 0.8))
    out["disk"] = user.get("disk", 1 << 62)
    return out


def get_balanced_memory(params, max_memory: Optional[dict] = None,
                        no_split_module_classes: Optional[list] = None, dtype=None,
                        low_zero: bool = False) -> "OrderedDict[DeviceId, int]":
    """Budgets that spread the model evenly over the devices instead of
    filling device 0 first; ``low_zero`` keeps device 0 at half a share."""
    budgets = get_max_memory(max_memory)
    device_ids = [k for k in budgets if isinstance(k, int)]
    if len(device_ids) <= 1:
        return budgets
    total = compute_module_sizes(params, dtype=dtype).get("", 0)
    units = _split_units(params, list(no_split_module_classes or []))
    # A mean unit of slack, so rounding units onto devices does not overflow.
    mean_unit = int(math.ceil(total / max(len(units), 1)))
    per_device = total // (len(device_ids) - (1 if low_zero else 0)) + mean_unit
    out = OrderedDict(budgets)
    for i in device_ids:
        out[i] = min(budgets[i], per_device // 2 if low_zero and i == 0 else per_device)
    return out


def _name_tree(tree) -> dict:
    """Nested dict of the parameter names (a parameter is an empty dict), in
    natural order at every level."""
    root: dict = {}
    for name in named_parameters(tree):
        node = root
        for part in name.split("."):
            node = node.setdefault(part, {})
    return root


def _split_units(tree, no_split: list) -> list:
    """The placement units in execution order: ``[(name, [prefixes])]``.

    A prefix is atomic when it is a parameter, when its last component or the
    whole prefix fully matches a ``no_split`` regex, or (for a module) when
    the submodule there is of a class named in ``no_split``
    (``"LlamaBlock"``, the reference's idiom)."""
    names = _name_tree(tree)
    module = tree if isinstance(tree, nn.Module) else None

    def atomic(prefix: str) -> bool:
        last = prefix.split(".")[-1]
        if module is not None:
            try:
                if type(module.get_submodule(prefix)).__name__ in no_split:
                    return True
            except AttributeError:
                pass  # a parameter, not a submodule
        return any(last == p or re.fullmatch(p, last) or re.fullmatch(p, prefix)
                   for p in no_split)

    units: list = []

    def walk(node: dict, prefix: str):
        if prefix and (not node or atomic(prefix)):
            units.append((prefix, [prefix]))
            return
        for key, child in node.items():
            walk(child, f"{prefix}.{key}" if prefix else key)

    walk(names, "")
    return units


def find_tied_parameters(params) -> list:
    """Groups of names that share one tensor (a module's ``named_parameters``
    drops the second name of a tie, so only dicts show ties)."""
    if isinstance(params, nn.Module):
        flat = dict(params.named_parameters(remove_duplicate=False))
    else:
        flat = named_parameters(params)
    by_id: dict = {}
    for name, leaf in flat.items():
        by_id.setdefault(id(leaf), []).append(name)
    return [g for g in by_id.values() if len(g) > 1]


def infer_auto_device_map(params, max_memory: Optional[dict] = None,
                          no_split_module_classes: Optional[list] = None, dtype=None,
                          tied_parameters: Optional[list] = None,
                          offload_buffers: bool = False,
                          verbose: bool = False) -> "OrderedDict[str, DeviceId]":
    """Greedy first fit of the model's units onto card, host, then disk.

    Returns ``{name prefix: device}`` covering every parameter. Once a unit
    moves past a tier, no later unit comes back to it. When anything spills
    past the cards, the first card keeps room for the largest unit, since
    streamed blocks pass through it when they run. Tied tensors count once,
    at their first name, and a unit holding only second names of a tie goes
    where the first name went. The map sizes parameters only, as the JAX
    solver does, so ``offload_buffers`` changes nothing; it is taken for
    the reference's signature."""
    no_split = list(no_split_module_classes or [])
    budgets = get_max_memory(max_memory)
    units = _split_units(params, no_split)
    leaves = named_parameters(params)
    tied = tied_parameters or find_tied_parameters(params)
    secondary_of = {other: group[0] for group in tied for other in group[1:]}

    def leaves_under(prefixes):
        return [n for n in leaves if any(n == p or n.startswith(p + ".") for p in prefixes)]

    def unit_size(prefixes):
        return sum(_leaf_bytes(leaves[n], dtype) for n in leaves_under(prefixes)
                   if n not in secondary_of)

    largest_unit = max((unit_size(ps) for _, ps in units), default=0)
    total = sum(unit_size(ps) for _, ps in units)
    device_ids: list = [k for k in budgets if isinstance(k, int)] + ["cpu", "disk"]
    spills = total > sum(budgets[d] for d in device_ids if isinstance(d, int))

    remaining = dict(budgets)
    if spills and isinstance(device_ids[0], int):
        remaining[device_ids[0]] = max(0, remaining[device_ids[0]] - largest_unit)
    device_map: "OrderedDict[str, DeviceId]" = OrderedDict()
    deferred = []
    cur = 0
    for name, prefixes in units:
        unit_leaves = leaves_under(prefixes)
        if unit_leaves and all(n in secondary_of for n in unit_leaves):
            deferred.append((name, secondary_of[unit_leaves[0]]))
            continue
        size = unit_size(prefixes)
        device_map[name] = "disk"
        while cur < len(device_ids):
            dev = device_ids[cur]
            if size <= remaining.get(dev, 0):
                device_map[name] = dev
                remaining[dev] -= size
                break
            cur += 1
        if verbose:
            print(f"  {name}: {size / 2**20:.1f} MiB -> {device_map[name]}")
    for name, primary in deferred:
        owner = next((u for u, ps in units if u in device_map
                      and any(primary == p or primary.startswith(p + ".") for p in ps)), None)
        device_map[name] = device_map[owner] if owner is not None else device_ids[0]
    return device_map


def check_device_map(params, device_map: dict) -> None:
    """Every parameter must be covered by a prefix of ``device_map``."""
    for name in named_parameters(params):
        if not any(p == "" or name == p or name.startswith(p + ".") for p in device_map):
            raise ValueError(f"Parameter {name} not covered by device_map")


def compute_module_total_buffer_size(tree, dtype=None) -> int:
    """Total bytes of the model's tensors."""
    return compute_module_sizes(tree, dtype=dtype).get("", 0)
