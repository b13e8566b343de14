"""Launch a function in several processes from one Python process.

Counterpart of ``accelerate_tpu/launchers.py`` (``notebook_launcher``,
``debug_launcher``). JAX drives every local chip from one process, so its
launchers only set the environment; torch runs one process a device, so
these start ``num_processes`` processes with ``torch.multiprocessing``'s
**spawn** method (a forked child of a process that touched CUDA fails)
and join them in one process group through the same ``ACCELERATE_TPU_*``
variables as ``accelerate-tpu-torch launch``. The function and its
arguments must be picklable (a module-level function). A child's
exception is raised in the caller.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

from .utils.environment import env_var, patch_environment


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_in_child(index: int, function, args, env: dict):
    """A spawned child: its rank is the machine's first plus ``index``."""
    os.environ.update(env)
    os.environ[env_var("PROCESS_ID")] = str(int(env[env_var("PROCESS_ID")]) + index)
    os.environ[env_var("LOCAL_PROCESS_ID")] = str(index)
    function(*args)


def _reset_states():
    from .state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def notebook_launcher(function, args=(), num_processes: Optional[int] = None,
                      mixed_precision: str = "no", use_port: str = "29500",
                      master_addr: Optional[str] = None, node_rank: int = 0, num_nodes: int = 1,
                      debug: bool = False, **mesh_axes: int):
    """Run ``function(*args)`` in ``num_processes`` processes of this
    machine (one card each), joined in one process group with the
    processes of the other ``num_nodes - 1`` machines (their
    ``master_addr:use_port`` rendezvous; this machine is ``node_rank``).
    With one process on one machine the function runs here, in this
    process. The mesh axes (``dp=``, ``fsdp=``, ``tp=``, ``cp=``, ``ep=``,
    ``pp=``) go to the processes as ``accelerate-tpu-torch launch``'s flags
    do (``ACCELERATE_TPU_MESH_<AXIS>``)."""
    import torch.multiprocessing as mp

    unknown = set(mesh_axes) - {"dp", "fsdp", "tp", "cp", "ep", "pp"}
    if unknown:
        raise TypeError(f"notebook_launcher() got unexpected keyword arguments {sorted(unknown)}")
    if num_nodes > 1 and master_addr is None:
        raise ValueError("notebook_launcher(num_nodes > 1) needs master_addr")
    local = int(num_processes or 1)
    env = {env_var("MIXED_PRECISION"): mixed_precision, env_var("FORK_LAUNCHED"): "false"}
    for ax, size in mesh_axes.items():
        env[env_var(f"MESH_{ax.upper()}")] = str(size)
    if debug:
        env[env_var("DEBUG")] = "true"
    if local == 1 and num_nodes == 1:
        try:
            with patch_environment(**env):
                return function(*args)
        finally:
            _reset_states()
    env.update({env_var("COORDINATOR_ADDRESS"): f"{master_addr or '127.0.0.1'}:{use_port}",
                env_var("NUM_PROCESSES"): str(local * num_nodes),
                env_var("PROCESS_ID"): str(node_rank * local)})
    env.setdefault("OMP_NUM_THREADS", os.environ.get("OMP_NUM_THREADS", "1"))
    mp.start_processes(_run_in_child, args=(function, args, env), nprocs=local, join=True,
                       start_method="spawn")


def debug_launcher(function, args=(), num_processes: int = 2):
    """Run ``function(*args)`` in ``num_processes`` CPU processes joined
    over gloo, on a free port of this machine: the multi-process paths
    without a card."""
    import torch.multiprocessing as mp

    env = {env_var("USE_CPU"): "true", env_var("FORK_LAUNCHED"): "false",
           env_var("COORDINATOR_ADDRESS"): f"127.0.0.1:{_free_port()}",
           env_var("NUM_PROCESSES"): str(num_processes), env_var("PROCESS_ID"): "0",
           "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    mp.start_processes(_run_in_child, args=(function, args, env), nprocs=num_processes,
                       join=True, start_method="spawn")
