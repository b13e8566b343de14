"""Environment variables and the process's environment.

Counterpart of ``accelerate_tpu/utils/environment.py``: the launcher
encodes its configuration as ``ACCELERATE_TPU_*`` variables and the state
reads them back with these helpers. ``get_gpu_info`` reads ``nvidia-smi``
(an empty list on a machine without a card); the JAX package's TPU
metadata reader has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import platform
import shutil
import socket
import subprocess
import sys
from functools import lru_cache
from typing import Any

from .constants import ENV_PREFIX


def str_to_bool(value: str) -> int:
    """1 for y, yes, t, true, on, 1; 0 for n, no, f, false, off, 0 (any
    case); anything else raises ``ValueError``."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def get_int_from_env(env_keys, default: int) -> int:
    """The first non-negative integer among the variables ``env_keys``."""
    for key in env_keys:
        value = int(os.environ.get(key, -1))
        if value >= 0:
            return value
    return default


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    """A boolean variable (:func:`str_to_bool`), ``default`` when unset."""
    return bool(str_to_bool(os.environ.get(key, str(default))))


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


def env_var(name: str) -> str:
    """Namespaced variable name: ``env_var("MIXED_PRECISION") ==
    "ACCELERATE_TPU_MIXED_PRECISION"``."""
    return ENV_PREFIX + name


def are_libraries_initialized(*library_names: str) -> list:
    """The names among ``library_names`` already imported."""
    return [lib for lib in library_names if lib in sys.modules]


@contextlib.contextmanager
def patch_environment(**kwargs):
    """Set variables (names upper-cased) inside the block; the previous
    values, or their absence, come back on exit."""
    existing = {}
    for key, value in kwargs.items():
        key = key.upper()
        if key in os.environ:
            existing[key] = os.environ[key]
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key in kwargs:
            key = key.upper()
            if key in existing:
                os.environ[key] = existing[key]
            else:
                os.environ.pop(key, None)


@lru_cache(maxsize=None)
def get_cpu_count() -> int:
    return os.cpu_count() or 1


def get_host_ip() -> str:
    """An address of this host other machines may reach it by: the one its
    name resolves to, else the loopback. Sends nothing on the network."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def check_os_kernel():
    """Warn on a Linux kernel older than 5.5 (processes can hang); return
    its ``(major, minor)``, None elsewhere."""
    info = platform.uname()
    if info.system != "Linux":
        return None
    try:
        version = tuple(int(v) for v in info.release.split("-")[0].split(".")[:2])
    except ValueError:
        return None
    if version < (5, 5):
        import logging

        logging.getLogger(__name__).warning(
            f"Detected kernel version {info.release}, which is below the recommended minimum of "
            "5.5; this can cause the process to hang. It is recommended to upgrade the kernel.")
    return version


def get_gpu_info():
    """``(names, count)`` of the NVIDIA cards ``nvidia-smi`` lists;
    ``([], 0)`` without one."""
    if shutil.which("nvidia-smi") is None:
        return [], 0
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return [], 0
    names = [line.strip() for line in out.splitlines() if line.strip()]
    return names, len(names)


def _cpus_of(cpulist: str) -> set:
    """The CPUs of a sysfs ``cpulist`` (``"0-3,8,10-11"``)."""
    cpus: set = set()
    for part in cpulist.strip().split(","):
        if "-" in part:
            lo, hi = part.split("-")
            cpus.update(range(int(lo), int(hi) + 1))
        elif part:
            cpus.add(int(part))
    return cpus


def _card_numa_node(local_process_index: int):
    """The NUMA node of the card this process drives (local index modulo
    the cards), from its PCI address in sysfs; None when there is no card
    or the machine does not say."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        props = torch.cuda.get_device_properties(local_process_index % torch.cuda.device_count())
        address = f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
        with open(f"/sys/bus/pci/devices/{address}/numa_node") as f:
            node = int(f.read().strip())
    except (AttributeError, OSError, RuntimeError, ValueError):
        return None
    return node if node >= 0 else None


def override_numa_affinity(local_process_index: int, verbose: bool | None = None) -> None:
    """Bind this process to the CPUs of the NUMA node of its card.

    The node is the card's own (its PCI device's ``numa_node``); without
    a card, or where sysfs does not name one, the nodes are dealt out by
    ``local_process_index`` as in the JAX package. A machine of one NUMA
    node (or none listed) is left as it is."""
    try:
        nodes = sorted(int(d[len("node"):]) for d in os.listdir("/sys/devices/system/node")
                       if d.startswith("node") and d[len("node"):].isdigit())
    except OSError:
        return
    if len(nodes) <= 1:
        return
    node = _card_numa_node(local_process_index)
    if node not in nodes:
        node = nodes[local_process_index % len(nodes)]
    try:
        with open(f"/sys/devices/system/node/node{node}/cpulist") as f:
            cpulist = f.read().strip()
        cpus = _cpus_of(cpulist)
        if cpus and hasattr(os, "sched_setaffinity"):
            os.sched_setaffinity(0, cpus)
            if verbose:
                print(f"Assigning process {local_process_index} to NUMA node {node} "
                      f"(cpus {cpulist})")
    except (OSError, ValueError):
        return


def run_command(cmd: list, capture: bool = False, env: dict[str, Any] | None = None):
    """Run ``cmd``; raise on a non-zero exit. ``capture`` returns its
    standard output."""
    if capture:
        return subprocess.run(cmd, capture_output=True, text=True, check=True, env=env).stdout
    return subprocess.run(cmd, check=True, env=env)
