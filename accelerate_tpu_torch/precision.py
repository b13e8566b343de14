"""Mixed-precision policies: explicit dtypes for params, compute and outputs.

Counterpart of ``accelerate_tpu/precision.py`` (``Policy``, ``policy_for``).
The default on the card, as on the TPU, is "bf16": f32 master params, bf16
compute, f32 outputs. Dynamic loss scaling (fp16 training) and fp8 are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class Policy:
    """Dtype policy (jmp-style)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Cast a module, tensor or nested dict/list/tuple of them to the compute dtype."""
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        """Cast to the (master) parameter dtype."""
        return _cast_floating(tree, self.param_dtype)

    def cast_to_output(self, tree):
        """Cast model outputs to the output dtype (f32 by default)."""
        return _cast_floating(tree, self.output_dtype)


def _cast_floating(tree, dtype):
    if isinstance(tree, nn.Module):
        return tree.to(dtype)  # nn.Module.to casts floating parameters only, in place
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree


def policy_for(mixed_precision) -> Policy:
    """Policy from an accelerate-style mixed_precision string.

    * "no"/"fp32": everything f32.
    * "bf16": f32 params, bf16 compute, f32 outputs.
    * "fp16": f32 params, fp16 compute, f32 outputs.
    """
    mp = str(mixed_precision)
    if mp in ("no", "fp32"):
        return Policy()
    if mp == "bf16":
        return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                      output_dtype=torch.float32)
    if mp == "fp16":
        return Policy(param_dtype=torch.float32, compute_dtype=torch.float16,
                      output_dtype=torch.float32)
    if mp == "fp8":
        raise NotImplementedError("mixed_precision='fp8' is not ported yet")
    raise ValueError(f"Unknown mixed precision mode {mixed_precision}")
