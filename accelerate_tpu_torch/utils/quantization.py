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

:func:`load_and_quantize_model` and :func:`load_and_quantize_hf_checkpoint`
(``accelerate_tpu/utils/quantization.py:207-335``) quantize a checkpoint
tensor by tensor as its shards stream, so host memory holds one
full-precision tensor at a time, and return the quantized state dict with
an ``apply_fn`` that dequantizes to ``QuantizationConfig.compute_dtype`` for
each call.
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
    they are; ``compute_dtype`` is what the loaders' ``apply_fn``
    dequantizes to."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    block_size: int = 64            # int4 contraction-dim block
    compute_dtype: torch.dtype = torch.bfloat16
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
    docstring for the layouts). ``transposed``: ``q`` and ``scale`` hold the
    quantization of the weight's transpose (an embedding table, whose
    channels run along dim -2), and :meth:`dequantize` transposes back."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int, block_size: int = 0,
                 transposed: bool = False):
        self.q = q
        self.scale = scale
        self.bits = int(bits)
        self.block_size = int(block_size)
        self.transposed = transposed

    @property
    def shape(self):
        """Shape of the logical tensor."""
        shape = tuple(self.q.shape)
        return shape[:-2] + shape[:-3:-1] if self.transposed else shape

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
            out = torch.mul(self.q, self.scale, out=out)
        else:
            shape = self.q.shape
            blocked = self.q.reshape(*shape[:-1], shape[-1] // self.block_size, self.block_size)
            out = (blocked.float() * self.scale).reshape(shape).to(dtype)
        return out.mT if self.transposed else out

    def nbytes(self) -> int:
        """Bytes at rest: the integers (int4 packed two to a byte) and the
        scales."""
        qb = self.q.numel() * (1 if self.bits == 8 else 0.5)
        return int(qb + self.scale.numel() * self.scale.element_size())

    def __repr__(self):
        return f"QuantizedTensor(int{self.bits}, shape={self.shape}, block={self.block_size})"


def quantize_tensor(w: torch.Tensor, bits: int = 8, block_size: int = 64,
                    transposed: bool = False) -> QuantizedTensor:
    """Symmetric quantization of a weight ``[..., out, in]``: round half to
    even of ``w / scale``, clipped to the symmetric range, with
    ``scale = amax / 127`` per output channel (8 bits) or ``amax / 7`` per
    block of ``block_size`` inputs (4 bits; the block shrinks by halves
    until it divides ``in``); an all-zero channel or block gets scale 1.
    ``transposed`` quantizes ``w`` as ``[..., in, out]`` (an embedding
    table, laid out as the JAX package's flax kernels are)."""
    if transposed:
        qt = quantize_tensor(w.mT, bits, block_size)
        qt.transposed = True
        return qt
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


def quantize_params(params: dict, config: QuantizationConfig, transposed=()) -> dict:
    """Quantize every eligible tensor of a ``{name: tensor}`` dict (a
    state dict); the others, and tensors already quantized, pass as they
    are. The names in ``transposed`` are embedding tables
    (:func:`quantize_tensor`)."""
    return {name: (quantize_tensor(t, bits=config.bits, block_size=config.block_size,
                                   transposed=name in transposed)
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


def load_and_quantize_model(module, checkpoint=None, params=None,
                            quantization_config: Optional[QuantizationConfig] = None, dtype=None,
                            key_map=None, device=None):
    """Load weights and quantize the eligible ones (:func:`eligible`):
    ``(quantized state dict, apply_fn)``, ``apply_fn(qparams, *args,
    **kwargs)`` running ``module`` (on the meta device is enough) on the
    weights dequantized to ``compute_dtype``.

    From a ``checkpoint`` (a safetensors file or directory) each tensor is
    read, moved to ``device``, cast to ``dtype`` and quantized before the
    next is read; ``key_map(checkpoint key)`` gives the port's name or None
    to skip (HF names: ``utils/hf_interop.map_hf_key``), and a parameter of
    ``module`` the checkpoint lacks raises. From ``params`` (a state dict)
    the tensors are quantized where they are moved. ``device`` defaults to
    the card (``utils/device.py``)."""
    from .device import resolve_device

    if quantization_config is None:
        raise ValueError("quantization_config is required")
    if (checkpoint is None) == (params is None):
        raise ValueError("pass exactly one of checkpoint / params")
    config = quantization_config
    device = resolve_device(device)
    # An embedding table is [vocab, hidden] here and in the JAX package,
    # where a projection's weight is the transpose of its flax kernel: its
    # channels run along dim -2, as the JAX package quantizes them.
    embeddings = {f"{owner}.weight" if owner else "weight"
                  for owner, m in module.named_modules() if isinstance(m, torch.nn.Embedding)}

    def prepared(t):
        t = torch.as_tensor(t).to(device)
        return t if dtype is None else t.to(dtype)

    if checkpoint is not None:
        from ..checkpointing import checkpoint_shards

        expected = set(dict(module.named_parameters()))
        qparams: dict = {}
        for shard in checkpoint_shards(checkpoint):
            for key in shard.keys():
                name = key_map(key) if key_map is not None else key
                if name is None or name not in expected:
                    continue
                t = prepared(shard.read(key))
                qparams[name] = (quantize_tensor(t, bits=config.bits, block_size=config.block_size,
                                                 transposed=name in embeddings)
                                 if eligible(name, t, config) else t)
        missing = expected - set(qparams)
        if missing:
            raise ValueError(f"Checkpoint {checkpoint} is missing keys: {sorted(missing)[:5]}...")
    else:
        qparams = quantize_params({n: prepared(t) for n, t in params.items()}, config,
                                  transposed=embeddings)

    def apply(p, *args, **kwargs):
        return torch.func.functional_call(module, p, args, kwargs)

    return qparams, quantizing_apply(apply, config.compute_dtype)


def load_and_quantize_hf_checkpoint(checkpoint_dir: str, quantization_config: QuantizationConfig,
                                    dtype=None, config=None, device=None):
    """Quantize an HF checkpoint directory in one call (the Llama family,
    the GPT-style families, T5, ...), the names translated tensor by tensor
    as the shards stream (no full-precision state dict). Returns ``(config,
    module, qparams, apply_fn)``, the module on the meta device."""
    from .hf_interop import map_hf_key, open_hf_checkpoint

    family, config, module = open_hf_checkpoint(checkpoint_dir, config)
    qparams, apply_fn = load_and_quantize_model(
        module, checkpoint=checkpoint_dir, quantization_config=quantization_config, dtype=dtype,
        key_map=lambda key: map_hf_key(key, family), device=device)
    return config, module, qparams, apply_fn
