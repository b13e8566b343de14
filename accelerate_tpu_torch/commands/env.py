"""``accelerate-tpu-torch env``: the versions, the cards and the launch
configuration, for a bug report (counterpart of
``accelerate_tpu/commands/env.py``)."""

from __future__ import annotations

import argparse
import platform
from pathlib import Path

from .config.config_args import default_config_file, load_config_from_file


def env_command(args) -> int:
    import numpy as np
    import torch

    from ..utils.environment import get_gpu_info

    lines = {
        "Platform": platform.platform(),
        "Python version": platform.python_version(),
        "torch version": torch.__version__,
        "numpy version": np.__version__,
        "CUDA version (torch)": torch.version.cuda,
        "CUDA available": torch.cuda.is_available(),
        "torch.distributed": torch.distributed.is_available(),
        "gloo available": torch.distributed.is_available()
        and torch.distributed.is_gloo_available(),
        "NCCL available": torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
    }
    if torch.cuda.is_available():
        lines["NCCL version"] = ".".join(map(str, torch.cuda.nccl.version()))
        lines["Card count"] = torch.cuda.device_count()
        lines["Cards"] = ", ".join(torch.cuda.get_device_name(i)
                                   for i in range(torch.cuda.device_count()))
    else:
        names, count = get_gpu_info()
        lines["Card count"] = count
        lines["Cards"] = ", ".join(names) or "none"
    print("\nCopy-and-paste the text below in your GitHub issue\n")
    for key, value in lines.items():
        print(f"- {key}: {value}")
    path = Path(args.config_file) if args.config_file else default_config_file()
    if path.exists():
        print(f"- accelerate-tpu-torch config ({path}):")
        for key, value in load_config_from_file(str(path)).to_dict().items():
            print(f"\t- {key}: {value}")
    else:
        print(f"- accelerate-tpu-torch config: not found ({path})")
    return 0


def env_command_parser(subparsers=None):
    description = "Print the environment, for bug reports"
    if subparsers is not None:
        parser = subparsers.add_parser("env", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch env", description=description)
    parser.add_argument("--config_file", default=None)
    if subparsers is not None:
        parser.set_defaults(func=env_command)
    return parser
