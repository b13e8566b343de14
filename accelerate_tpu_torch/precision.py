"""Mixed-precision policies and dynamic loss scaling.

Counterpart of ``accelerate_tpu/precision.py``: a policy of explicit dtypes
for params, compute and outputs (``Policy``, ``policy_for``), and for fp16
a loss-scale state (``LossScaleState``) kept as tensors on the device and
advanced by pure functions, as torch's GradScaler would. The default on the
card, as on the TPU, is "bf16": f32 master params, bf16 compute, f32
outputs, and no scaling (bf16 has f32's exponent range). The scaling's
settings are ``utils/dataclasses.py``'s ``GradScalerKwargs``. fp8 is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from .utils.dataclasses import GradScalerKwargs


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


class LossScaleState(NamedTuple):
    """Functional GradScaler state, tensors on the device."""

    scale: torch.Tensor           # current loss scale, f32
    growth_tracker: torch.Tensor  # consecutive finite steps, int32
    fin_steps: torch.Tensor       # total applied steps (diagnostics), int32


def make_loss_scale(kwargs: Optional[GradScalerKwargs] = None, enabled: bool = True,
                    device=None) -> Optional[LossScaleState]:
    """The initial state, or None when scaling is off."""
    kwargs = kwargs or GradScalerKwargs()
    if not enabled or not kwargs.enabled:
        return None
    return LossScaleState(
        scale=torch.tensor(kwargs.init_scale, dtype=torch.float32, device=device),
        growth_tracker=torch.zeros((), dtype=torch.int32, device=device),
        fin_steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def scale_loss(loss, scale_state: Optional[LossScaleState]):
    if scale_state is None:
        return loss
    return loss * scale_state.scale.to(loss.dtype)


def unscale_grads(grads, scale_state: Optional[LossScaleState]):
    """Each gradient times 1/scale (computed in f32, returned in its dtype)."""
    if scale_state is None:
        return list(grads)
    inv = 1.0 / scale_state.scale
    return [(g.float() * inv).to(g.dtype) for g in grads]


def grads_finite(grads) -> torch.Tensor:
    """A bool tensor: every entry of every gradient is finite."""
    grads = list(grads)
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_loss_scale(scale_state: LossScaleState, finite: torch.Tensor,
                      kwargs: Optional[GradScalerKwargs] = None) -> LossScaleState:
    """Grow the scale after ``growth_interval`` finite steps in a row, back it
    off after a non-finite one (GradScaler.update semantics)."""
    kwargs = kwargs or GradScalerKwargs()
    finite = finite.to(scale_state.scale.device)
    tracker = torch.where(finite, scale_state.growth_tracker + 1,
                          torch.zeros_like(scale_state.growth_tracker))
    grow = tracker >= kwargs.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, scale_state.scale * kwargs.growth_factor, scale_state.scale),
        scale_state.scale * kwargs.backoff_factor,
    )
    tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
    return LossScaleState(scale=new_scale, growth_tracker=tracker,
                          fin_steps=scale_state.fin_steps + finite.to(torch.int32))
