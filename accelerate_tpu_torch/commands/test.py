"""``accelerate-tpu-torch test``: check the install by launching the
omnibus script (``test_utils/scripts/test_script.py``) in a process group
(counterpart of ``accelerate_tpu/commands/test.py``). On the cards by
default, one process a card; ``--cpu`` runs the processes on the CPU over
gloo."""

from __future__ import annotations

import argparse
import subprocess
import sys


def test_command(args) -> int:
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
           "--num_processes", str(args.num_processes)]
    if args.cpu:
        cmd.append("--use_cpu_emulation")
    cmd += ["--module", "accelerate_tpu_torch.test_utils.scripts.test_script"]
    print("Running:", " ".join(cmd))
    rc = subprocess.run(cmd).returncode
    print("Test is a success! You are ready for your distributed training!" if rc == 0
          else f"Test FAILED (exit {rc})")
    return rc


def test_command_parser(subparsers=None):
    description = "Run the omnibus correctness script to check the setup"
    if subparsers is not None:
        parser = subparsers.add_parser("test", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch test", description=description)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU over gloo instead of the cards")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="Processes in the group (one card each)")
    if subparsers is not None:
        parser.set_defaults(func=test_command)
    return parser
