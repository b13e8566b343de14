"""Weight-only int8 / int4 quantization.

Counterpart of ``accelerate_tpu/utils/quantization.py:33-205``. As in the
JAX package, quantization is a transformation of parameters: an eligible
weight becomes a :class:`QuantizedTensor` (int8 per output channel, or int4
in blocks along the contraction dim, both symmetric) and is dequantized
just before it is used, so at rest it stays integer.

Layout: a ``torch.nn.Linear`` weight is ``[..., out, in]`` where the flax
kernel is ``[..., in, out]``, so every reduction runs over the last dim
here and over dim -2 there; after that transpose the integers are the JAX
package's. int8: ``q`` int8 ``[..., out, in]``, ``scale`` f32
``[..., out, 1]``. int4: the values ``-8..7`` in an int8 tensor (torch has
no packed int4 dtype), ``scale`` ``[..., out, in/bs, 1]`` over ``q`` seen as
``[..., out, in/bs, bs]``; :meth:`QuantizedTensor.nbytes` counts half a
byte each, the packed size.

``load_and_quantize_model`` and ``load_and_quantize_hf_checkpoint`` of the
JAX module come with the checkpoint loaders (ROADMAP.md, A9), and with them
``QuantizationConfig.compute_dtype``, which only they read.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch


@dataclasses.dataclass
class QuantizationConfig:
    """Which weights to quantize and how. ``skip_modules`` are regexes
    searched in a parameter's dotted name (the head stays full precision by
    default); ``min_weight_size`` keeps small tensors (norms, biases) as
    they are."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    block_size: int = 64            # int4 contraction-dim block
    skip_modules: Optional[list] = None
    min_weight_size: int = 4096

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("Choose one of load_in_8bit / load_in_4bit")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("Set load_in_8bit=True or load_in_4bit=True")
        if self.skip_modules is None:
            self.skip_modules = ["lm_head"]

    @property
    def bits(self) -> int:
        """8 or 4, from load_in_8bit/load_in_4bit."""
        return 8 if self.load_in_8bit else 4


class QuantizedTensor:
    """An integer-quantized weight and its scales (see the module
    docstring for the layouts)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int, block_size: int = 0):
        self.q = q
        self.scale = scale
        self.bits = int(bits)
        self.block_size = int(block_size)

    @property
    def shape(self):
        """Shape of the logical tensor."""
        return tuple(self.q.shape)

    @property
    def dtype(self):
        """The dtype the scales (and a dequantization) carry."""
        return self.scale.dtype

    @property
    def ndim(self):
        return self.q.dim()

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The full-precision tensor, ``q * scale`` in f32 cast to ``dtype``
        (for 8 bits in one pass: the product is formed in f32 and rounded
        once as it is stored, bit for bit the f32 product cast)."""
        if self.bits == 8:
            out = torch.empty(self.q.shape, dtype=dtype, device=self.q.device)
            return torch.mul(self.q, self.scale, out=out)
        shape = self.q.shape
        blocked = self.q.reshape(*shape[:-1], shape[-1] // self.block_size, self.block_size)
        return (blocked.float() * self.scale).reshape(shape).to(dtype)

    def nbytes(self) -> int:
        """Bytes at rest: the integers (int4 packed two to a byte) and the
        scales."""
        qb = self.q.numel() * (1 if self.bits == 8 else 0.5)
        return int(qb + self.scale.numel() * self.scale.element_size())

    def __repr__(self):
        return f"QuantizedTensor(int{self.bits}, shape={self.shape}, block={self.block_size})"


def quantize_tensor(w: torch.Tensor, bits: int = 8, block_size: int = 64) -> QuantizedTensor:
    """Symmetric quantization of a weight ``[..., out, in]``: round half to
    even of ``w / scale``, clipped to the symmetric range, with
    ``scale = amax / 127`` per output channel (8 bits) or ``amax / 7`` per
    block of ``block_size`` inputs (4 bits; the block shrinks by halves
    until it divides ``in``); an all-zero channel or block gets scale 1."""
    if w.dim() < 2:
        raise ValueError(f"quantize_tensor expects ndim>=2, got {tuple(w.shape)}")
    f = w.detach().float()
    if bits == 8:
        amax = f.abs().amax(dim=-1, keepdim=True)                  # [..., out, 1]
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
        return QuantizedTensor(q, scale, 8)
    if bits == 4:
        n_in = f.shape[-1]
        if n_in % block_size != 0:
            bs = block_size
            while n_in % bs != 0:
                bs //= 2
            block_size = max(bs, 1)
        blocked = f.reshape(*f.shape[:-1], n_in // block_size, block_size)
        amax = blocked.abs().amax(dim=-1, keepdim=True)            # [..., out, nb, 1]
        scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(blocked / scale), -8, 7).to(torch.int8)
        return QuantizedTensor(q.reshape(f.shape), scale, 4, block_size)
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def eligible(name: str, tensor, config: QuantizationConfig) -> bool:
    """Whether the parameter ``name`` (dotted) is quantized under
    ``config``: two or more dims, at least ``min_weight_size`` elements,
    and no ``skip_modules`` regex found in its name."""
    if isinstance(tensor, QuantizedTensor):
        return False
    if tensor.dim() < 2 or tensor.numel() < config.min_weight_size:
        return False
    return not any(re.search(p, name) for p in config.skip_modules or [])


def quantize_params(params: dict, config: QuantizationConfig) -> dict:
    """Quantize every eligible tensor of a ``{name: tensor}`` dict (a
    state dict); the others, and tensors already quantized, pass as they
    are."""
    return {name: (quantize_tensor(t, bits=config.bits, block_size=config.block_size)
                   if eligible(name, t, config) else t)
            for name, t in params.items()}


def dequantize_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Every :class:`QuantizedTensor` of ``params`` back to a dense tensor."""
    return {name: (t.dequantize(dtype) if isinstance(t, QuantizedTensor) else t)
            for name, t in params.items()}


def quantized_nbytes(params: dict) -> int:
    """Bytes at rest of a (partly) quantized ``{name: tensor}`` dict."""
    return sum(t.nbytes() if isinstance(t, QuantizedTensor) else t.numel() * t.element_size()
               for t in params.values())


def quantizing_apply(apply_fn, compute_dtype=torch.bfloat16):
    """Wrap ``apply_fn(params, *args, **kwargs)`` so that quantized entries
    of ``params`` are dequantized to ``compute_dtype`` for the call; the
    dense copies live for the call only."""

    def wrapped(params, *args, **kwargs):
        return apply_fn(dequantize_params(params, compute_dtype), *args, **kwargs)

    return wrapped
