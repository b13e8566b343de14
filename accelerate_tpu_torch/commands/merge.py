"""``accelerate-tpu-torch merge-weights``: consolidate a sharded checkpoint
into one safetensors file.

Counterpart of ``accelerate_tpu/commands/merge.py``. It reads either
layout the port writes:

* a ``save_state`` directory (``Accelerator.save_state``): its
  ``model.safetensors``, or under FSDP each process's chunks
  (``model.rank<r>-of-<n>.safetensors`` by ``model.layout.json``) put back
  together;
* a ``save_model`` export split into ``model-0000i-of-0000n.safetensors``
  shards with ``model.safetensors.index.json`` (or one
  ``model.safetensors``).

Merging only moves bytes on the host: nothing touches the card.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def merge_command(args) -> int:
    from ..checkpointing import _export_tensors, merged_model_tensors, save_safetensors
    from ..utils.constants import SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME

    src = Path(args.checkpoint_dir)
    if not src.exists():
        print(f"{src} does not exist")
        return 2
    if (src / SAFE_WEIGHTS_INDEX_NAME).exists() or (src / SAFE_WEIGHTS_NAME).exists():
        flat = _export_tensors(src)
    elif (src / "model.layout.json").exists():
        flat = merged_model_tensors(src)
    else:
        print(f"{src} holds neither a save_state model nor a save_model export")
        return 2
    out = Path(args.output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: v.contiguous() for k, v in flat.items()}
    save_safetensors(flat, out, {"format": "pt"})
    total = sum(v.numel() * v.element_size() for v in flat.values())
    print(f"Merged {len(flat)} tensors ({total / 2**20:.1f} MiB) -> {out}")
    return 0


def merge_command_parser(subparsers=None):
    description = "Consolidate a sharded checkpoint into a single safetensors file"
    if subparsers is not None:
        parser = subparsers.add_parser("merge-weights", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch merge-weights",
                                         description=description)
    parser.add_argument("checkpoint_dir", help="save_state directory or sharded safetensors dir")
    parser.add_argument("output_path", help="Output .safetensors path")
    if subparsers is not None:
        parser.set_defaults(func=merge_command)
    return parser


def main():
    return merge_command(merge_command_parser().parse_args())


if __name__ == "__main__":
    import sys

    sys.exit(main() or 0)
