"""``accelerate-tpu-torch config update`` (counterpart of
``accelerate_tpu/commands/config/update.py``).

Rewrites an existing config file in the current schema: the values the
file sets are kept, fields added since it was written get their defaults,
and unknown keys are reported and dropped. A file the JAX package wrote
updates to what its own ``config update`` writes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config_args import default_config_file, load_config_from_file


def update_config(args) -> str:
    """Rewrite ``args.config_file`` (default: the default file); returns
    its path. A missing file raises ``FileNotFoundError``."""
    config_file = args.config_file
    if config_file is None:
        if not default_config_file().exists():
            raise FileNotFoundError(f"No config file at {default_config_file()}; run "
                                    "`accelerate-tpu-torch config` first.")
        config_file = str(default_config_file())
    elif not Path(config_file).exists():
        raise FileNotFoundError(f"The config file {config_file} doesn't exist.")
    cfg = load_config_from_file(config_file)
    for note in cfg.migration_notes:
        print(f"note: {note}")
    if cfg.extra:
        print(f"Dropping unknown keys: {sorted(cfg.extra)}")
        cfg.extra = {}
    cfg.save(config_file)
    return config_file


def update_command_parser(subparsers=None):
    description = "Update an existing config file to the current schema, keeping its values"
    if subparsers is not None:
        parser = subparsers.add_parser("update", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch config update",
                                         description=description)
    parser.add_argument("--config_file", default=None,
                        help="Config file to update (default: the default config path)")
    if subparsers is not None:
        parser.set_defaults(func=update_config_command)
    return parser


def update_config_command(args) -> int:
    try:
        path = update_config(args)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(f"Successfully updated the configuration at {path}.")
    return 0
