"""`accelerate-tpu-torch` CLI root, the counterpart of
``accelerate_tpu/commands/accelerate_cli.py``.

Subcommands are registered lazily; each lives in its own module under
``accelerate_tpu_torch.commands``: ``config`` (the questionnaire, and its
``default`` and ``update`` subcommands), ``env``, ``launch``, ``loadtest``, ``merge-weights``,
``serve`` and ``test``. ``estimate-memory`` comes with the other model
families (ROADMAP A9); ``tpu-config`` is the JAX package's alone.
"""

from __future__ import annotations

import argparse
import sys


def _subcommand_registrars():
    """name -> registrar import, resolved lazily so one broken subcommand
    can't take down the rest."""

    def _lazy(module: str, attr: str):
        def load():
            import importlib

            return getattr(importlib.import_module(module, __package__), attr)

        return load

    return {
        "config": _lazy(".config.config", "config_command_parser"),
        "env": _lazy(".env", "env_command_parser"),
        "launch": _lazy(".launch", "launch_command_parser"),
        "loadtest": _lazy(".loadtest", "loadtest_command_parser"),
        "merge-weights": _lazy(".merge", "merge_command_parser"),
        "serve": _lazy(".serve", "serve_command_parser"),
        "test": _lazy(".test", "test_command_parser"),
    }


def main():
    parser = argparse.ArgumentParser(
        "accelerate-tpu-torch", usage="accelerate-tpu-torch <command> [<args>]",
        allow_abbrev=False
    )
    subparsers = parser.add_subparsers(help="accelerate-tpu-torch command helpers",
                                       dest="command")
    for name, load in _subcommand_registrars().items():
        try:
            load()(subparsers=subparsers)
        except ImportError as e:  # partial build: register the rest anyway
            print(f"warning: subcommand {name} unavailable ({e})", file=sys.stderr)

    args = parser.parse_args()
    if not hasattr(args, "func"):
        parser.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
