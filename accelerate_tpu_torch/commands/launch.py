"""``accelerate-tpu-torch launch``: run a training script in one process, or
in a process group of several.

Counterpart of ``accelerate_tpu/commands/launch.py``. The JAX launcher runs
one process a host; torch runs one process a card, so ``--num_processes N``
starts N processes on this machine (one card each, NCCL; or on the CPU over
gloo with ``--use_cpu_emulation``) that join one process group through
``ACCELERATE_TPU_COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
/ ``LOCAL_PROCESS_ID``: ``PartialState`` reads them. The launcher picks the
rendezvous port and hands it to every child. ``--num_machines M
--machine_rank R --main_process_ip --main_process_port`` runs this
machine's one process of an M-machine world instead. Without
``--num_processes`` the script runs alone, with no process group.

Each child gets ``OMP_NUM_THREADS=1`` unless it is set. When a child fails
the launcher stops the others and exits with that child's code (a process
left waiting in a collective would hang). ``--max_restarts`` starts the
whole world again, ``--restart_backoff`` seconds later (doubling), with
``ACCELERATE_TPU_RESTART_COUNT`` telling the script which attempt it is.

``--dp/--fsdp/--tp/--cp/--pp/--ep N`` lay the processes out over a mesh
(``parallel/mesh.py``): the children get ``ACCELERATE_TPU_MESH_<AXIS>=N``,
which their ``AcceleratorState`` builds the mesh from. One axis may be -1
(it takes the processes the others leave; with none, dp does), and the
product of the others must divide the number of processes. An ``fsdp``
axis above 1 builds the default ``FullyShardedDataParallelPlugin``, which
reads the ``FSDP_*`` variables (``FSDP_SHARDING_STRATEGY``,
``FSDP_OFFLOAD_PARAMS``, ``FSDP_ACTIVATION_CHECKPOINTING``,
``FSDP_ZERO_SHARDING``, ``FSDP_MIN_NUM_PARAMS``), which pass through.

Refused: ``--emulated_device_count`` above 1 (a torch process has one
device), and the JAX package's TPU-pod flags (``--gcloud``, ``--tpu_name``, ``--tpu_zone``).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import subprocess
import sys
import time

from ..launchers import _free_port
from .config.config_args import ClusterConfig, load_config_from_file


def launch_command_parser(subparsers=None):
    description = "Launch a training script in one process or a process group"
    if subparsers is not None:
        parser = subparsers.add_parser("launch", description=description, allow_abbrev=False)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch launch", description=description,
                                         allow_abbrev=False)
    parser.add_argument("--config_file", default=None, help="Config file to launch with")
    parser.add_argument("--mixed_precision", default=None, choices=["no", "bf16", "fp16"])
    parser.add_argument("--debug", action="store_true", default=None,
                        help="Compare every rank's shapes before each tensor collective")
    parser.add_argument("--dp", type=int, default=None, help="data-parallel mesh axis")
    parser.add_argument("--fsdp", type=int, default=None,
                        help="param-shard (FSDP/ZeRO) mesh axis")
    parser.add_argument("--tp", type=int, default=None, help="tensor-parallel mesh axis")
    parser.add_argument("--cp", type=int, default=None, help="context-parallel mesh axis")
    parser.add_argument("--ep", type=int, default=None, help="expert-parallel mesh axis")
    parser.add_argument("--pp", type=int, default=None, help="pipeline-parallel mesh axis")
    parser.add_argument("--num_machines", type=int, default=None, help="Number of machines")
    parser.add_argument("--machine_rank", type=int, default=None, help="This machine's rank")
    parser.add_argument("--main_process_ip", default=None)
    parser.add_argument("--main_process_port", type=int, default=None)
    parser.add_argument("--gcloud", action="store_true", help="JAX package only (TPU pods)")
    parser.add_argument("--tpu_name", default=None, help="JAX package only (TPU pods)")
    parser.add_argument("--tpu_zone", default=None, help="JAX package only (TPU pods)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Start N processes on this machine in one process group")
    parser.add_argument("--max_restarts", type=int, default=0,
                        help="Start the script again up to N times after a failure")
    parser.add_argument("--restart_backoff", type=float, default=2.0,
                        help="Seconds before a restart (doubling each time)")
    parser.add_argument("--use_cpu_emulation", action="store_true", default=None,
                        help="Run the processes on the CPU over gloo instead of the cards")
    parser.add_argument("--emulated_device_count", type=int, default=None,
                        help="Devices a process: 1 (a torch process has one)")
    parser.add_argument("--module", action="store_true",
                        help="Run the script as a module (python -m)")
    parser.add_argument("training_script", help="Script (or module) to launch")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER,
                        help="Arguments of the script")
    if subparsers is not None:
        parser.set_defaults(func=launch_command)
    return parser


_OVERRIDES = [
    ("mixed_precision", "mixed_precision"), ("debug", "debug"),
    ("dp", "mesh_dp"), ("fsdp", "mesh_fsdp"), ("tp", "mesh_tp"), ("cp", "mesh_cp"),
    ("ep", "mesh_ep"), ("pp", "mesh_pp"), ("num_machines", "num_machines"),
    ("machine_rank", "machine_rank"), ("main_process_ip", "main_process_ip"),
    ("main_process_port", "main_process_port"), ("use_cpu_emulation", "use_cpu_emulation"),
]


def _resolve_config(args) -> ClusterConfig:
    """The config file's values, the flags given on top."""
    cfg = load_config_from_file(args.config_file)
    for arg_name, cfg_name in _OVERRIDES:
        value = getattr(args, arg_name, None)
        if value is not None:
            setattr(cfg, cfg_name, value)
    return cfg


def _build_command(args) -> list:
    cmd = [sys.executable] + (["-m", args.training_script] if args.module
                              else [args.training_script])
    return cmd + list(args.training_script_args)


def _wait_all(procs: list) -> int:
    """Wait for every child; once one fails, stop the rest. Returns the
    first failure's exit code, else 0."""
    failed = None
    while True:
        codes = [p.poll() for p in procs]
        if failed is None:
            failed = next((c for c in codes if c not in (None, 0)), None)
            if failed is not None:
                for p, c in zip(procs, codes):
                    if c is None:
                        p.send_signal(signal.SIGTERM)
                deadline = time.monotonic() + 10.0
        if all(c is not None for c in codes):
            return failed or 0
        if failed is not None and time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.05)


def simple_launcher(args, cfg: ClusterConfig) -> int:
    """The script alone in one process, without a process group."""
    return subprocess.run(_build_command(args), env={**os.environ, **cfg.launch_env()}).returncode


def multi_process_launcher(args, cfg: ClusterConfig) -> int:
    """This machine's processes of one process group: ``--num_processes``
    local ones on a port picked here, or the one process of
    ``--machine_rank`` in a ``--num_machines`` world."""
    from ..utils.environment import env_var

    base = {**os.environ, **cfg.launch_env()}
    base.setdefault("OMP_NUM_THREADS", "1")
    if cfg.num_machines > 1:
        address = f"{cfg.main_process_ip}:{cfg.main_process_port}"
        world, first, local = cfg.num_machines, cfg.machine_rank, 1
    else:
        address = f"127.0.0.1:{_free_port()}"
        world, first, local = args.num_processes, 0, args.num_processes
    procs = []
    for i in range(local):
        env = dict(base)
        env[env_var("COORDINATOR_ADDRESS")] = address
        env[env_var("NUM_PROCESSES")] = str(world)
        env[env_var("PROCESS_ID")] = str(first + i)
        env[env_var("LOCAL_PROCESS_ID")] = str(i)
        procs.append(subprocess.Popen(_build_command(args), env=env))
    try:
        return _wait_all(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def launch_with_restarts(run, args) -> int:
    """``run()`` again after a non-zero exit, up to ``--max_restarts``
    times, with a doubling backoff."""
    backoff = max(args.restart_backoff, 0.0)
    attempt = 0
    while True:
        os.environ["ACCELERATE_TPU_RESTART_COUNT"] = str(attempt)
        rc = run()
        if rc == 0 or attempt >= args.max_restarts:
            return rc
        attempt += 1
        print(f"[accelerate-tpu-torch launch] exit code {rc}; restart {attempt}/"
              f"{args.max_restarts} in {backoff:.1f}s", file=sys.stderr)
        time.sleep(backoff)
        backoff = min(backoff * 2, 60.0)


def validate_launch(args, cfg: ClusterConfig) -> list:
    """What stops the launch, as readable lines (empty: launch)."""
    problems = []
    if not args.module and not os.path.exists(args.training_script):
        problems.append(f"training script not found: {args.training_script}")
    world = (args.num_processes or 1) if (cfg.num_machines or 1) <= 1 else cfg.num_machines
    sizes = cfg.mesh_axes()
    absorbing = [ax for ax, v in sizes.items() if v == -1]
    bad = {ax: v for ax, v in sizes.items() if v < -1}
    if bad:
        problems.append(f"mesh axes must be positive or -1 (all remaining), got {bad}")
    if len(absorbing) > 1:
        problems.append(f"only one mesh axis may be -1, got {absorbing}")
    explicit = math.prod(v for ax, v in sizes.items() if v > 0)
    if world % explicit:
        problems.append(f"mesh axes {sizes} (product {explicit}) do not divide the {world} "
                        "process(es)")
    if args.emulated_device_count is not None and args.emulated_device_count > 1:
        problems.append(f"--emulated_device_count {args.emulated_device_count}: a torch "
                        "process drives one device; start more processes with --num_processes")
    if args.gcloud or args.tpu_name or args.tpu_zone:
        problems.append("--gcloud/--tpu_name/--tpu_zone launch on TPU pods: JAX package only")
    if args.num_processes is not None and args.num_processes < 1:
        problems.append(f"--num_processes must be >= 1, got {args.num_processes}")
    if args.max_restarts < 0:
        problems.append(f"--max_restarts must be >= 0, got {args.max_restarts}")
    n_machines = cfg.num_machines or 1
    if cfg.machine_rank is not None and not 0 <= cfg.machine_rank < n_machines:
        problems.append(f"machine_rank {cfg.machine_rank} out of range for num_machines "
                        f"{n_machines}")
    if n_machines > 1 and not cfg.main_process_ip:
        problems.append("a launch over several machines needs main_process_ip/port")
    if args.num_processes and args.num_processes > 1 and n_machines > 1:
        problems.append("--num_processes and --num_machines > 1 are exclusive: each machine "
                        "runs one process")
    if not cfg.use_cpu_emulation:
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        wanted = args.num_processes or 1
        if cards == 0:
            problems.append("no CUDA card is visible; pass --use_cpu_emulation to run on the "
                            "CPU over gloo")
        elif wanted > cards:
            problems.append(f"--num_processes {wanted} on {cards} card(s): NCCL takes one card "
                            "a process")
    return problems


def launch_command(args) -> int:
    cfg = _resolve_config(args)
    problems = validate_launch(args, cfg)
    if problems:
        for p in problems:
            print(f"[accelerate-tpu-torch launch] error: {p}", file=sys.stderr)
        return 2
    if args.num_processes is not None or cfg.num_machines > 1:
        return launch_with_restarts(lambda: multi_process_launcher(args, cfg), args)
    return launch_with_restarts(lambda: simple_launcher(args, cfg), args)


def main():
    return launch_command(launch_command_parser().parse_args())


if __name__ == "__main__":
    sys.exit(main() or 0)
