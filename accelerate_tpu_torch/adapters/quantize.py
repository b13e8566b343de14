"""Serving-side base-weight quantization under an exact LoRA path.

Counterpart of ``accelerate_tpu/adapters/quantize.py``. The serving
engine's ``weights_dtype="int8"`` keeps the base projections' weights as
per-output-channel symmetric int8 (``utils.quantization.quantize_tensor``)
in :class:`QuantizedLinear` modules, which dequantize just before their
product, in plain torch: the JAX engine dequantizes at the top of each
compiled program and leaves the fusion to XLA, so there is no kernel to
port. Adapters stay full precision in the :class:`~.registry.AdapterBank`,
so a tenant's delta rides exactly on the quantized base.

``shardings_for_quantized`` of the JAX module comes with tensor-parallel
serving (ROADMAP.md, A8).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.quantization import (
    QuantizationConfig,
    QuantizedTensor,
    dequantize_params,
    eligible,
    quantize_tensor,
    quantized_nbytes,
)

__all__ = ["QuantizedLinear", "dequantize_params", "quantize_base_weights", "quantized_nbytes",
           "SERVING_MIN_WEIGHT_SIZE", "SERVING_SKIP_MODULES"]

#: Tensors below this size stay full precision (norms, biases, tiny heads).
SERVING_MIN_WEIGHT_SIZE = 256

#: Kept full precision for output quality: the head, and the embedding
#: table, whose per-row scale fits a vocabulary-long axis poorly.
SERVING_SKIP_MODULES = ("lm_head", "embed")


class QuantizedLinear(nn.Module):
    """A linear layer whose weight is int8 at rest (``weight_q`` [out, in],
    ``weight_scale`` f32 [out, 1]) and is dequantized to ``compute_dtype``
    (the weight's dtype before quantization) just before each product."""

    def __init__(self, quantized: QuantizedTensor, bias: Optional[nn.Parameter],
                 compute_dtype: torch.dtype):
        super().__init__()
        if quantized.bits != 8:
            raise NotImplementedError("serving quantizes base weights to int8 only")
        self.out_features, self.in_features = quantized.shape
        self.register_buffer("weight_q", quantized.q)
        self.register_buffer("weight_scale", quantized.scale)
        self.bias = bias
        self.compute_dtype = compute_dtype

    def dequantized_weight(self) -> torch.Tensor:
        return QuantizedTensor(self.weight_q, self.weight_scale, 8).dequantize(self.compute_dtype)

    def forward(self, x):
        return F.linear(x, self.dequantized_weight(), self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, int8"


def _config(min_weight_size, skip_modules) -> QuantizationConfig:
    return QuantizationConfig(
        load_in_8bit=True,
        min_weight_size=(SERVING_MIN_WEIGHT_SIZE if min_weight_size is None
                         else int(min_weight_size)),
        skip_modules=list(SERVING_SKIP_MODULES if skip_modules is None else skip_modules))


@torch.no_grad()
def quantize_base_weights(model: nn.Module, *, min_weight_size: Optional[int] = None,
                          skip_modules=None) -> nn.Module:
    """A copy of ``model`` whose eligible ``nn.Linear`` layers (weight of at
    least ``min_weight_size`` elements, name matching no ``skip_modules``
    regex) are :class:`QuantizedLinear`. Everything else, the embedding and
    the head included, is shared with ``model``, which is left as it was:
    the copy costs the int8 weights and their scales."""
    config = _config(min_weight_size, skip_modules)

    def rebuild(module: nn.Module, prefix: str) -> nn.Module:
        if isinstance(module, nn.Linear) and eligible(f"{prefix}weight", module.weight, config):
            return QuantizedLinear(quantize_tensor(module.weight, bits=8), module.bias,
                                   module.weight.dtype)
        new = copy.copy(module)
        new._parameters = dict(module._parameters)
        new._buffers = dict(module._buffers)
        new._modules = {name: (None if child is None else rebuild(child, f"{prefix}{name}."))
                        for name, child in module._modules.items()}
        return new

    return rebuild(model, "")


def dequantized_state_dict(model: nn.Module) -> dict:
    """The state dict of a model whose :class:`QuantizedLinear` layers are
    read back as plain ``weight`` tensors in their compute dtype: the
    weights a full-precision model needs to compute what the quantized one
    computes."""
    out = {}
    for name, tensor in model.state_dict().items():
        if name.endswith(".weight_scale"):
            continue
        if name.endswith(".weight_q"):
            owner = model.get_submodule(name[:-len(".weight_q")])
            out[name[:-len("_q")]] = owner.dequantized_weight()
        else:
            out[name] = tensor
    return out
