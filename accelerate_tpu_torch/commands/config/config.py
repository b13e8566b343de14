"""``accelerate-tpu-torch config default``: the configuration command.

Counterpart of ``accelerate_tpu/commands/config/config.py`` without its
questionnaire (``menu.py``, ``update.py``), which is ROADMAP.md, A8b's
remainder: only the ``default`` subcommand is here.
"""

from __future__ import annotations

import argparse

from .config_args import default_config_file
from .default import write_basic_config


def config_command(args) -> int:
    path = write_basic_config(mixed_precision=args.mixed_precision,
                              config_file=args.config_file)
    print(f"accelerate-tpu-torch config written to {path}")
    return 0


def config_command_parser(subparsers=None):
    description = "Write the launch configuration file"
    if subparsers is not None:
        parser = subparsers.add_parser("config", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch config", description=description)
    sub = parser.add_subparsers(dest="config_command", required=True)
    default = sub.add_parser("default", description="Write a one-machine default config")
    default.add_argument("--config_file", default=None,
                         help=f"Where to write it (default {default_config_file()})")
    default.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    default.set_defaults(func=config_command)
    return parser
