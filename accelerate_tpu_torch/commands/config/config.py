"""``accelerate-tpu-torch config``: the questionnaire that writes the
launch configuration file, ``config default`` (no questions) and ``config
update`` (``update.py``).

Counterpart of ``accelerate_tpu/commands/config/config.py``. The questions
follow the JAX package's, in its order; multiple-choice ones go through
the cursor menu (``../menu.py``), which asks a numbered prompt when stdin
is not a TTY. Where the JAX package asks for TPU hosts this asks for
machines: ``MULTI_MACHINE`` is its ``TPU_POD``, and the TPU name and zone
(gcloud orchestration) are not asked. Every field written is
``ClusterConfig``'s, so either package reads the other's file.
"""

from __future__ import annotations

import argparse
from typing import Optional

from ..menu import select
from .config_args import ClusterConfig, default_config_file
from .default import write_basic_config


def _ask(question: str, default: str, choices: Optional[list] = None) -> str:
    if choices:
        return select(question, choices, default=default)
    try:
        answer = input(f"{question} ({default}): ").strip()
    except EOFError:
        answer = ""
    return answer or default


def _ask_int(question: str, default: int) -> int:
    raw = _ask(question, str(default))
    try:
        return int(raw)
    except ValueError:
        return default


def get_user_input() -> ClusterConfig:
    """The configuration from the questionnaire's answers."""
    cfg = ClusterConfig()
    cfg.compute_environment = _ask(
        "Compute environment", "LOCAL_MACHINE", ["LOCAL_MACHINE", "MULTI_MACHINE"])
    if cfg.compute_environment == "MULTI_MACHINE":
        cfg.num_machines = _ask_int(
            "Number of machines (each runs `launch --num_processes` processes, one a card)", 1)
        if cfg.num_machines > 1:
            cfg.main_process_ip = _ask("IP of the main machine (machine 0)", "") or None
            cfg.main_process_port = _ask_int("Port on the main machine", 8476)
            cfg.machine_rank = _ask_int("Rank of this machine", 0)
    cfg.mixed_precision = _ask("Mixed precision", "bf16", ["no", "bf16", "fp16"])
    cfg.mesh_dp = _ask_int("Mesh: data-parallel size (-1 = all remaining processes)", -1)
    cfg.mesh_fsdp = _ask_int("Mesh: FSDP (param-shard) size", 1)
    cfg.mesh_tp = _ask_int("Mesh: tensor-parallel size", 1)
    cfg.mesh_cp = _ask_int("Mesh: context-parallel size (long sequences)", 1)
    cfg.mesh_pp = _ask_int("Mesh: pipeline-parallel size", 1)
    cfg.mesh_ep = _ask_int("Mesh: expert-parallel size (MoE)", 1)
    cfg.debug = _ask("Enable debug mode (collective shape checks)", "no", ["yes", "no"]) == "yes"
    return cfg


def config_command(args) -> int:
    if args.default:
        path = write_basic_config(mixed_precision=args.mixed_precision,
                                  config_file=args.config_file)
        print(f"accelerate-tpu-torch config written to {path}")
        return 0
    path = get_user_input().save(args.config_file)
    print(f"accelerate-tpu-torch config saved to {path}")
    return 0


def config_command_parser(subparsers=None):
    description = "Write the launch configuration file (the questionnaire, unless --default)"
    if subparsers is not None:
        parser = subparsers.add_parser("config", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch config", description=description)
    parser.add_argument("--config_file", default=None,
                        help=f"Where to write it (default {default_config_file()})")
    parser.add_argument("--default", action="store_true",
                        help="Skip the questionnaire; write a one-machine default")
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    # Subcommands; the bare `config` runs the questionnaire.
    sub = parser.add_subparsers(dest="config_subcommand")
    default = sub.add_parser("default", description="Write a one-machine default config")
    default.add_argument("--config_file", default=None,
                         help=f"Where to write it (default {default_config_file()})")
    default.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    default.set_defaults(func=config_command, default=True)
    from .update import update_command_parser

    update_command_parser(subparsers=sub)
    if subparsers is not None:
        parser.set_defaults(func=config_command)
    return parser
