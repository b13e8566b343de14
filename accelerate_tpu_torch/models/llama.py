"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``accelerate_tpu/models/llama.py``. Module and parameter
names mirror the flax tree (``q_proj``, ``input_norm.scale``,
``embed_tokens``...) so ``utils/convert.py`` moves weights across by name;
the layout is ``[batch, seq, heads, head_dim]`` throughout, as in JAX.

* The uncached full-sequence forward runs attention through
  ``ops/attention.py::flash_attention``: the Hopper flash kernel on the
  card, the einsum path elsewhere.
* The KV-cached path (``cache=`` / ``cache_pos=``, used by ``generate``) is
  plain tensor code, as the JAX package leaves it to XLA. The cache is a
  list of per-layer dicts updated in place (JAX returns a new cache; the
  port writes into the buffers it was given, and returns them). A tensor
  ``cache_pos`` [B] gives each row its own write position, over slot rows
  or a pool of pages (:func:`_update_slots_and_attend`): the serving
  engine's steps, which a CUDA graph captures.
* Parameters keep the module's dtype; a bf16 run builds or casts the module
  to bf16 (``precision.py``), or trains f32 masters through
  ``Accelerator.compile_train_step``, which casts them inside the
  differentiated function.
* The loss factories (:func:`causal_lm_loss`, :func:`fused_causal_lm_loss`)
  return ``loss_fn(params, batch)`` over a dict of parameter tensors, run
  through ``torch.func.functional_call``: the JAX contract
  ``loss_fn(params, batch[, rng])``.
* Under FSDP the accelerator attaches a sharded layout
  (``parallel/sharding.py``) to the model: the decoder-layer loops then
  take each layer's parameters from a gather, one layer at a time
  (``_layer_prefixes`` names where), inside the layer's checkpoint when
  the plugin reshards after the forward.
* On a mesh (``parallel/mesh.py``): under tensor parallelism a layer's
  projections hold this process's chunk, column parallel (q/k/v, gate,
  up) and row parallel (o, down), between Megatron's f and g
  (``parallel/sharding.py``'s :class:`_SumGradient`, and
  :class:`_ReduceFromTP`), so attention sees ``H/tp``
  and ``G/tp`` heads; a LoRA adapter's factors apply inside the same
  column and row products, and the serving engine's KV cache holds this
  process's heads (``serving/mesh_exec.py``); a serving shard's embedding
  table (split on hidden) and head (on the vocabulary) gather their
  activations whole; under context parallelism each process runs its
  ``S/cp`` tokens of every row (the loss factories cut them, rotary takes
  global positions) and attention is ring or Ulysses
  (``ops/ring_attention.py``); ``PipelinedLlamaForCausalLM`` applies its
  stacked blocks through ``parallel/pipeline.py``'s GPipe schedule.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    _einsum_attention,
    flash_attention,
    flash_attention_available,
    softcap_logits,
)
from ..ops.quant import FP8_FORMATS, Fp8Dense
from ..parallel.sharding import (
    RematPolicy,
    _GatherSplit,
    _SliceReplicated,
    _SumGradient,
    resolve_remat_policy,
)
from ..utils.device import resolve_device


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # HF-style rope scaling dict, e.g. {"rope_type": "llama3", "factor": 8.0,
    # "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    # "original_max_position_embeddings": 8192} or {"rope_type": "linear",
    # "factor": 2.0}. None = vanilla RoPE.
    rope_scaling: Optional[dict] = None
    # Mistral-style local attention: each token sees only the last N keys.
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    # Family knobs that turn this skeleton into Qwen2 / Gemma:
    # Qwen2 puts biases on the q/k/v projections (never on o_proj).
    attention_qkv_bias: bool = False
    attention_out_bias: bool = False
    # Gemma: GeGLU MLP ("gelu_tanh"), zero-centered RMSNorm scales (the
    # checkpoint stores w with the norm computing 1 + w), sqrt(hidden)
    # embedding scaling, and a head_dim decoupled from hidden/heads.
    mlp_activation: str = "silu"  # "silu" (SwiGLU) | "gelu_tanh"/"gelu_exact" (GeGLU)
    rms_norm_unit_offset: bool = False
    scale_embeddings: bool = False
    head_dim_override: Optional[int] = None
    # Gemma2: per-layer attention patterns and sandwich norms.
    # layer_windows[i] is layer i's sliding window (None = full attention);
    # overrides the uniform sliding_window when set. post_norms adds the
    # 4-norm block. Softcaps bound logits via cap * tanh(x / cap);
    # query_pre_attn_scalar replaces head_dim in the attention scale.
    layer_windows: Optional[tuple] = None
    post_norms: bool = False
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    # Training memory: remat=True checkpoints each decoder layer
    # (torch.utils.checkpoint, non-reentrant) under remat_policy
    # (parallel/sharding.py): "dots" keeps the outputs of the products
    # without batch dims (the projections, handed back to the recompute by
    # _remat_layer) and recomputes the rest in the backward, the flash
    # kernel included; "nothing" recomputes the whole layer; "everything"
    # keeps it all (no checkpoint).
    remat: bool = False
    remat_policy: str = "dots"
    use_flash_attention: bool = True
    # "auto" | "ring" | "ulysses" | "flash" | "einsum": "auto" takes ring or
    # Ulysses attention when the ambient mesh has cp > 1
    # (ops/ring_attention.py), flash/einsum otherwise.
    attention_backend: str = "auto"
    # Pallas tile sizes of the JAX package; the Hopper kernel's tiles are
    # fixed, so the port reads neither.
    flash_block_q: int = 128
    flash_block_k: int = 128
    # fp8 projections (ops/quant.py's Fp8Dense, delayed scaling) in every
    # decoder layer; pair with Accelerator(mixed_precision="fp8").
    use_fp8: bool = False
    fp8_margin: int = 0
    fp8_amax_history_len: int = 16
    fp8_amax_compute_algo: str = "max"
    fp8_format: str = "HYBRID"

    @classmethod
    def llama3_8b(cls, **overrides):
        cfg = cls(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0,
        )
        return dataclasses.replace(cfg, **overrides)

    @classmethod
    def qwen2_7b(cls, **overrides):
        cfg = cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
            max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-6,
            attention_qkv_bias=True,
        )
        return dataclasses.replace(cfg, **overrides)

    @classmethod
    def gemma2_9b(cls, **overrides):
        cfg = cls(
            vocab_size=256000, hidden_size=3584, intermediate_size=14336,
            num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
            head_dim_override=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
            tie_word_embeddings=True, mlp_activation="gelu_tanh",
            rms_norm_unit_offset=True, scale_embeddings=True, post_norms=True,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
            query_pre_attn_scalar=256.0,
            layer_windows=tuple(4096 if i % 2 == 0 else None for i in range(42)),
        )
        return dataclasses.replace(cfg, **overrides)

    @classmethod
    def tiny(cls, **overrides):
        """Test-size config."""
        cfg = cls(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128,
        )
        return dataclasses.replace(cfg, **overrides)

    @property
    def head_dim(self):
        """Per-head width: hidden_size // num_attention_heads, unless the
        family decouples it (``head_dim_override``, e.g. Gemma)."""
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def sm_scale(self):
        """Attention logit scale: 1/sqrt(query_pre_attn_scalar or head_dim)."""
        base = self.query_pre_attn_scalar
        return (base if base is not None else self.head_dim) ** -0.5

    def window_for(self, layer_idx: int):
        """Layer ``layer_idx``'s sliding window (None = full attention)."""
        if self.layer_windows is not None:
            return self.layer_windows[layer_idx]
        return self.sliding_window


def _linear(cfg: LlamaConfig, in_features: int, out_features: int, bias: bool, device, dtype):
    """A decoder layer's projection: :class:`_Projection`, or under
    ``cfg.use_fp8`` an fp8 one (``ops/quant.py``'s ``Fp8Dense``, the JAX
    ``_dense_factory``; the embedding and ``lm_head`` stay high-precision)."""
    if cfg.use_fp8:
        fwd, bwd = FP8_FORMATS[cfg.fp8_format]
        return _Fp8Projection(in_features, out_features, use_bias=bias, param_dtype=dtype,
                              device=device, margin=cfg.fp8_margin,
                              amax_history_len=cfg.fp8_amax_history_len,
                              amax_compute_algo=cfg.fp8_amax_compute_algo, fwd_dtype=fwd,
                              bwd_dtype=bwd)
    return _Projection(in_features, out_features, bias=bias, device=device, dtype=dtype)


class _Projection(nn.Linear):
    """A decoder layer's projection: ``nn.Linear``, whose output a "dots"
    remat keeps (:func:`_remat_layer`). Under tensor parallelism its weight
    is this process's chunk: :func:`column_parallel` and
    :func:`row_parallel` apply it (and an int8 ``QuantizedLinear``'s)."""

    def forward(self, x):
        if _kept_products is None:
            return F.linear(x, self.weight, self.bias)
        return _KeptProduct.apply(x, self.weight, self.bias, _kept_products)

    def _product(self, x):
        if _kept_products is None:
            return F.linear(x, self.weight)
        return _KeptProduct.apply(x, self.weight, None, _kept_products)


class _Fp8Projection(Fp8Dense):
    """A decoder layer's fp8 projection, whose product a "dots" remat keeps
    as it keeps :class:`_Projection`'s. (Never tensor parallel: the
    accelerator refuses fp8 under tp > 1.)"""

    def forward(self, x):
        return self._fp8_forward(x, kept=_kept_products)


def _lora_factors(mod, dtype):
    """``(a, b, scale)`` of one adapted module in ``dtype``; a per-row
    ``scale`` [B] broadcast over ``[B, S, out]``."""
    scale = mod["scale"].to(dtype)
    if scale.dim() == 1:
        scale = scale[:, None, None]
    return mod["a"].to(dtype), mod["b"].to(dtype), scale


def column_parallel(proj: nn.Module, x, tp, lora=None):
    """Column parallel: ``proj``'s chunk gives this process's output
    features; a bias (which the JAX policy replicates) contributes its
    slice. A LoRA module ``lora`` (``a`` whole, ``b`` this process's
    columns, as the JAX ``bank_shardings`` lays a column target out; a
    whole ``b`` is cut here) adds its delta to the same columns."""
    y = proj._product(x)
    k = y.shape[-1]
    if proj.bias is not None:
        y = y + _SliceReplicated.apply(proj.bias, tp, 0, k)
    if lora is not None:
        a, b, scale = _lora_factors(lora, x.dtype)
        if b.shape[-1] != k:
            b = b.narrow(-1, tp.index * k, k)
        y = y + ((x @ a) @ b) * scale
    return y


def row_parallel(proj: nn.Module, x, tp, lora=None):
    """Row parallel: ``proj``'s chunk takes this process's input features;
    the partial products are summed over ``tp`` (:class:`_ReduceFromTP`),
    then the bias is added once. A LoRA module ``lora`` (``a`` this
    process's rows, ``b`` whole, as the JAX ``bank_shardings`` lays a row
    target out) sums its ``[.., r]`` partial ``x @ a`` in the same
    all-reduce, then adds ``(x @ a) @ b`` once."""
    part = proj._product(x)
    if lora is None:
        y = _ReduceFromTP.apply(part, tp)
    else:
        a, b, scale = _lora_factors(lora, x.dtype)
        n = x.shape[-1]
        if a.shape[-2] != n:
            a = a.narrow(-2, tp.index * n, n)
        width = part.shape[-1]
        both = _ReduceFromTP.apply(torch.cat([part, (x @ a).to(part.dtype)], dim=-1), tp)
        y, u = both[..., :width], both[..., width:]
    if proj.bias is not None:
        y = y + proj.bias
    if lora is not None:
        y = y + (u.to(x.dtype) @ b) * scale
    return y


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: after a row-parallel projection, the sum of every
    process's partial output over ``tp``; the identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        return group.all_reduce(y.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split_group(local: int, full: int, what: str = "a projection"):
    """The mesh's ``tp`` group when a tensor holds ``local`` of ``full``
    along its split dim, else None (whole)."""
    if local == full:
        return None
    from ..parallel.mesh import axis_group

    group = axis_group("tp")
    if group is None or local * group.size != full:
        raise ValueError(f"{what} of width {local} of {full} does not split over the "
                         f"mesh's tp axis ({None if group is None else group.size})")
    return group


def _tp_group(proj: nn.Module, full: int):
    """The mesh's ``tp`` group when projection ``proj``'s weight holds
    ``full`` output rows split over it, else None. The weight is a float
    ``weight``, or an int8 ``QuantizedLinear``'s ``weight_q``."""
    weight = getattr(proj, "weight", None)
    if weight is None:
        weight = getattr(proj, "weight_q", None)
    local = full if weight is None else weight.shape[0]
    return _split_group(local, full)


class RMSNorm(nn.Module):
    """RMS norm in f32, returned in the input dtype. ``unit_offset`` (Gemma)
    stores zero-centered scales and computes ``(1 + w) * x_hat``."""

    def __init__(self, dim: int, eps: float = 1e-5, unit_offset: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.unit_offset = unit_offset
        init = torch.zeros if unit_offset else torch.ones
        self.scale = nn.Parameter(init(dim, device=device, dtype=dtype))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        norm = x32 * torch.rsqrt(var + self.eps)
        scale = self.scale.float()
        if self.unit_offset:
            scale = 1.0 + scale
        return (norm * scale).to(x.dtype)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` in f32 (``scale`` and ``bias``, the flax
    names), returned in the input dtype: the norm of the GPT-style families
    and BERT."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.scale.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def gelu(x, approximate: bool):
    """GELU: the tanh approximation (``jax.nn.gelu``'s default, HF's
    gelu_new/gelu_fast/gelu_pytorch_tanh) or the exact erf form (HF's
    gelu/gelu_python)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _run_blocks(blocks, x, cache=None, cache_pos=None):
    """``x`` through every block of ``blocks`` (each ``block(x, cache=,
    cache_pos=)``, the blocks of the GPT-style families), threading the
    per-layer KV cache in place when one is given."""
    for i, block in enumerate(blocks):
        if cache is None:
            x = block(x)
        else:
            x, cache[i] = block(x, cache=cache[i], cache_pos=cache_pos)
    return x


def _start_of(cache_pos) -> int:
    """Where this call's positions start: ``cache_pos``, or 0 uncached."""
    return 0 if cache_pos is None else int(cache_pos)


def _check_learned_positions(start: int, seq: int, table: int, what: str):
    """Refuse positions ``[start, start + seq)`` past a learned position
    table of ``table`` rows, on the host before the lookup: on the card an
    out-of-range embedding index is a device-side assert that ends the
    process's CUDA context (flax clips the index instead)."""
    if start + seq > table:
        raise ValueError(f"positions [{start}, {start + seq}) run past {what}'s learned position "
                         f"table of {table} rows")


def scale_rope_frequencies(inv_freq: torch.Tensor, rope_scaling: dict) -> torch.Tensor:
    """Apply HF-style RoPE scaling to the base inverse frequencies.

    "linear" divides every frequency by ``factor``; "llama3" keeps high
    frequencies, scales low frequencies by ``factor`` and interpolates the
    band in between."""
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    if rope_type in ("default", None):
        return inv_freq
    factor = float(rope_scaling.get("factor", 1.0))
    if rope_type == "linear":
        return inv_freq / factor
    if rope_type == "llama3":
        low = float(rope_scaling.get("low_freq_factor", 1.0))
        high = float(rope_scaling.get("high_freq_factor", 4.0))
        original = float(rope_scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = original / low
        high_wavelen = original / high
        smooth = (original / wavelen - low) / (high - low)
        interpolated = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, interpolated)
        return torch.where(wavelen < high_wavelen, inv_freq, scaled)
    raise NotImplementedError(f"rope_scaling type {rope_type!r} (supported: linear, llama3)")


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float,
                     dtype=torch.float32, rope_scaling: Optional[dict] = None):
    """RoPE tables: returns (cos, sin) of shape [..., seq, head_dim//2]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exponents / head_dim))
    if rope_scaling:
        inv_freq = scale_rope_frequencies(inv_freq, rope_scaling)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [batch, seq, heads, head_dim]; rotate pairs (even, odd halves)."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def multi_head_attention(q, k, v, causal: bool = True, use_flash: bool = True,
                         segment_ids=None, backend: str = "auto",
                         sliding_window: Optional[int] = None,
                         block_q: int = 128, block_k: int = 128,
                         sm_scale: Optional[float] = None,
                         logit_softcap: Optional[float] = None):
    """Dispatch between the attention implementations in ops/ (reference
    ``accelerate_tpu/models/llama.py:264-350``).

    ``logit_softcap`` (Gemma2) runs inside the flash kernel (causal only)
    and the einsum path. ``sliding_window`` narrower than the sequence
    routes to the banded flash kernel (O(S*w)) or the windowed einsum mask;
    a window as wide as the sequence is full causal attention.

    backend: 'auto' and 'flash' take the flash kernel when it tiles the
    input, else einsum; 'einsum' always takes einsum. On a mesh whose
    ``cp`` axis is above one process, q/k/v are this process's sequence
    chunks: 'ring' and 'ulysses' run that context-parallel strategy
    (``ops/ring_attention.py``), and 'auto' picks one when nothing (segment
    ids, ``sm_scale``, a softcap or a narrower window) needs the whole
    sequence; otherwise the chunks are gathered, attended whole and cut
    again (:func:`_over_whole_sequence`). On a ``cp`` axis of one the
    'ring' and 'ulysses' backends take the flash path, as in the JAX
    package. ``block_q``/``block_k`` are the JAX package's flash tile
    sizes: taken, and fixed by the kernel routes here
    (``ops/attention.py``'s ``flash_attention``)."""
    if backend not in ("auto", "ring", "ulysses", "flash", "einsum"):
        raise ValueError(
            f"unknown attention_backend {backend!r}; expected auto/ring/ulysses/flash/einsum")
    from ..parallel.mesh import axis_group

    cp = axis_group("cp")
    seq = q.shape[1] * (cp.size if cp is not None else 1)
    if backend in ("ring", "ulysses"):
        # The context-parallel strategies reject what they would drop.
        if logit_softcap is not None:
            raise ValueError(f"attention_backend={backend!r} does not support logit_softcap")
        if sliding_window is not None and sliding_window < seq:
            raise ValueError(f"attention_backend={backend!r} does not support sliding_window")
        if segment_ids is not None:
            raise ValueError(f"attention_backend={backend!r} does not support segment_ids")
        if sm_scale is not None:
            raise ValueError(f"attention_backend={backend!r} does not support sm_scale")
    if cp is not None:
        whole_window = sliding_window is None or sliding_window >= seq
        if backend in ("ring", "ulysses") or (
                backend == "auto" and logit_softcap is None and whole_window
                and segment_ids is None and sm_scale is None):
            from ..ops.ring_attention import context_parallel_attention

            return context_parallel_attention(q, k, v, causal=causal, strategy=backend,
                                              use_flash=use_flash)
        return _over_whole_sequence(cp, q, k, v, segment_ids, functools.partial(
            _local_attention, causal=causal, use_flash=use_flash, backend=backend,
            sliding_window=sliding_window, sm_scale=sm_scale, logit_softcap=logit_softcap))
    return _local_attention(q, k, v, segment_ids, causal=causal, use_flash=use_flash,
                            backend=backend, sliding_window=sliding_window, sm_scale=sm_scale,
                            logit_softcap=logit_softcap)


def _local_attention(q, k, v, segment_ids, causal, use_flash, backend, sliding_window,
                     sm_scale, logit_softcap):
    """Attention over the sequence ``q`` holds: the flash kernel or the
    einsum path (``multi_head_attention``'s rules)."""
    if logit_softcap is not None:
        window = (sliding_window if sliding_window is not None
                  and sliding_window < q.shape[1] else None)
        if backend != "einsum" and use_flash and causal and flash_attention_available(q):
            return flash_attention(q, k, v, causal=True, sliding_window=window,
                                   segment_ids=segment_ids, sm_scale=sm_scale,
                                   logit_softcap=logit_softcap)
        return _einsum_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                 sliding_window=sliding_window, sm_scale=sm_scale,
                                 logit_softcap=logit_softcap)
    if sliding_window is not None and sliding_window < q.shape[1]:
        if backend != "einsum" and use_flash and causal:
            return flash_attention(q, k, v, causal=True, sliding_window=sliding_window,
                                   segment_ids=segment_ids, sm_scale=sm_scale)
        return _einsum_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                 sliding_window=sliding_window, sm_scale=sm_scale)
    if backend != "einsum" and use_flash and flash_attention_available(q):
        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                               sm_scale=sm_scale)
    return _einsum_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                             sm_scale=sm_scale)


def _over_whole_sequence(group, q, k, v, segment_ids, attend):
    """``attend`` over the whole sequence from this process's chunks: q,
    k, v (and the segment ids) gathered over the ``cp`` group, this
    process's chunk of the output kept. What the JAX package's GSPMD does
    for an attention its context-parallel strategies do not take."""
    S = q.shape[1]
    qw, kw, vw = (_GatherSplit.apply(t, group, 1) for t in (q, k, v))
    seg = group.all_gather(segment_ids.contiguous(), 1) if segment_ids is not None else None
    return attend(qw, kw, vw, seg).narrow(1, group.index * S, S)


def _window_of(config, layer_idx: int):
    """Layer ``layer_idx``'s sliding window: ``config.window_for`` where the
    config has one (the Llama family), else its ``sliding_window`` if any;
    the other families' configs duck-type the cache fields."""
    if hasattr(config, "window_for"):
        return config.window_for(layer_idx)
    return getattr(config, "sliding_window", None)


def init_kv_cache(config: LlamaConfig, batch_size: int, max_len: int, dtype=torch.bfloat16,
                  ring_slack: int = 0, device=None):
    """Per-layer KV cache: a list of ``{"k", "v"}`` with [B, max_len, n_kv, hd]
    buffers (KV heads unrepeated). Sliding-window layers narrower than
    ``max_len`` get a RING buffer of ``window + ring_slack`` slots with a
    ``pos`` buffer [B, slots] of each slot's global position (-1 = never
    written)."""
    device = resolve_device(device)
    caches = []
    n_kv, hd = config.num_key_value_heads, config.head_dim
    for i in range(config.num_hidden_layers):
        w = _window_of(config, i)
        if w is not None and w < max_len:
            size = min(w + ring_slack, max_len)
            shape = (batch_size, size, n_kv, hd)
            caches.append({
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.full((batch_size, size), -1, dtype=torch.int32, device=device),
            })
        else:
            shape = (batch_size, max_len, n_kv, hd)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def _cached_attention(q, k_all, v_all, cache_pos: int, n_rep: int, sliding_window=None,
                      sm_scale=None, logit_softcap=None, alibi_slopes=None):
    """q [B, S, H, hd] against the whole dense cache [B, L, n_kv, hd]: keys at
    global index <= cache_pos + (local query index) are valid, which covers
    prefill and decode alike."""
    S = q.shape[1]
    L = k_all.shape[1]
    q_pos = cache_pos + torch.arange(S, device=q.device)
    k_pos = torch.arange(L, device=q.device)[None, :]
    mask = k_pos <= q_pos[:, None]
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos[:, None] - sliding_window)
    return _grouped_cached_attention(q, k_all.transpose(1, 2), v_all.transpose(1, 2), mask[None],
                                     n_rep, sm_scale=sm_scale, logit_softcap=logit_softcap,
                                     alibi_slopes=alibi_slopes, k_positions=k_pos[0])


def _ring_cached_attention(q, cache, cache_pos: int, n_rep: int, window: int,
                           sm_scale=None, logit_softcap=None, alibi_slopes=None):
    """Ring-cache decode: a slot is visible iff it was written (pos >= 0),
    is not in the query's future and lies inside the window."""
    S = q.shape[1]
    q_pos = cache_pos + torch.arange(S, device=q.device)
    slot_pos = cache["pos"][:, None, :]
    mask = ((slot_pos >= 0) & (slot_pos <= q_pos[None, :, None])
            & (slot_pos > q_pos[None, :, None] - window))  # [B, S, W]
    return _grouped_cached_attention(q, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
                                     mask, n_rep, sm_scale=sm_scale, logit_softcap=logit_softcap,
                                     alibi_slopes=alibi_slopes, k_positions=cache["pos"])


def _update_slots_and_attend(cache, q, k, v, pos, n_rep: int, sliding_window=None,
                             sm_scale=None, logit_softcap=None, alibi_slopes=None):
    """The serving engine's cached attention: row ``b`` writes its K/V at
    positions ``pos[b] + i`` and attends keys at positions ``<=`` its
    query's. ``pos`` [B] is a tensor and nothing here reads it on the host,
    so a CUDA graph can capture the call, and the rows may stand at
    different positions. The engine keeps its K/V head-major, so that each
    row's view reaches the attention in one gather and one cast. Two
    layouts of ``cache``:

    * slot rows: ``"k"``/``"v"`` [R, n_kv, L, hd]; ``"rows"`` [B] names the
      rows of this batch (absent: every row, R == B).
    * pages: ``"k"``/``"v"`` [N, n_kv, P, hd] (a pool of P-token pages)
      with ``"table"`` [B, Np] of page ids; a row's view is its Np pages end
      to end. ``"write"`` [B] bool, where given, sends the writes of the
      rows it clears to page 0, the engine's scratch page.

    Write positions are clamped into the view. Keys past a query's position
    (a slot's stale or scratch entries) are masked by replacement, so they
    add exactly 0 to its output."""
    k_all, v_all, mask = _write_slots_and_views(cache, k, v, pos, sliding_window)
    k_positions = None if alibi_slopes is None else torch.arange(k_all.shape[2],
                                                                 device=q.device)
    return _grouped_cached_attention(q, k_all, v_all, mask, n_rep, sm_scale=sm_scale,
                                     logit_softcap=logit_softcap, alibi_slopes=alibi_slopes,
                                     k_positions=k_positions)


def _write_slots_and_views(cache, k, v, pos, sliding_window=None):
    """The write half of :func:`_update_slots_and_attend`: ``k``/``v`` [B,
    S, n_kv, hd] written at ``pos[b] + i``, then each row's K/V view [B,
    n_kv, L, hd] and the validity mask [B, S, L] of its queries."""
    B, S = k.shape[:2]
    dev = pos.device
    q_pos = pos[:, None] + torch.arange(S, device=dev)  # [B, S]
    ck, cv = cache["k"], cache["v"]
    G, hd = ck.shape[1], ck.shape[3]
    heads = torch.arange(G, device=dev)
    if "table" in cache:
        table = cache["table"]
        P = ck.shape[2]
        L = table.shape[1] * P
        w = q_pos.clamp(0, L - 1)
        page = table.gather(1, w // P)
        if cache.get("write") is not None:
            page = torch.where(cache["write"][:, None], page, torch.zeros_like(page))
        index = (page.reshape(-1, 1), heads, (w % P).reshape(-1, 1))
        # Each row's view in one gather of whole (page, head) blocks:
        # [B, n_kv, Np] block ids into the pool seen as [N * n_kv, P, hd].
        blocks = (table[:, None, :] * G + heads[None, :, None]).reshape(-1)
    else:
        rows = cache.get("rows")
        L = ck.shape[2]
        w = q_pos.clamp(0, L - 1)
        r = torch.arange(B, device=dev) if rows is None else rows
        index = (r[:, None].expand(B, S).reshape(-1, 1), heads, w.reshape(-1, 1))
    ck.index_put_(index, k.reshape(B * S, G, hd).to(ck.dtype))
    cv.index_put_(index, v.reshape(B * S, G, hd).to(cv.dtype))
    if "table" in cache:
        k_all = ck.view(-1, P, hd).index_select(0, blocks).view(B, G, L, hd)
        v_all = cv.view(-1, P, hd).index_select(0, blocks).view(B, G, L, hd)
    else:
        k_all = ck if rows is None else ck.index_select(0, rows)
        v_all = cv if rows is None else cv.index_select(0, rows)
    k_pos = torch.arange(L, device=dev)[None, None, :]
    mask = k_pos <= q_pos[:, :, None]  # [B, S, L]
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos[:, :, None] - sliding_window)
    return k_all, v_all, mask


def _head_dim_split_attend(cache, q, k, v, pos, tp, sliding_window=None, sm_scale=None,
                           logit_softcap=None):
    """Cached attention when the K/V heads do not split over ``tp`` and the
    cache holds this process's slice of ``head_dim`` of every K/V head (the
    JAX ``SliceExec.heads_axis`` fallback): ``k``/``v`` [B, S, n_kv, hd]
    whole, this process's ``hd / tp`` of them written, the views gathered
    whole over ``tp``, and this process's query heads ``q`` [B, S, H / tp,
    hd] attend the K/V heads they read, each repeated to its query head."""
    B, S, h_local, hd = q.shape
    n_kv = k.shape[2]
    part = hd // tp.size
    at = tp.index * part
    k_all, v_all, mask = _write_slots_and_views(cache, k.narrow(3, at, part),
                                                v.narrow(3, at, part), pos, sliding_window)
    k_all, v_all = (tp.all_gather(t.contiguous(), 3) for t in (k_all, v_all))
    rep = h_local * tp.size // n_kv
    kv_of = (tp.index * h_local + torch.arange(h_local, device=q.device)) // rep
    return _grouped_cached_attention(q, k_all.index_select(1, kv_of),
                                     v_all.index_select(1, kv_of), mask, 1, sm_scale=sm_scale,
                                     logit_softcap=logit_softcap)


def _grouped_cached_attention(q, k_all, v_all, mask, n_rep: int, sm_scale=None,
                              logit_softcap=None, alibi_slopes=None, k_positions=None):
    """Cached-attention core in f32: q [B, S, H, hd] against head-major K/V
    views [B, n_kv, L, hd] (any strides; a token-major cache passes
    ``.transpose(1, 2)``) with a validity mask [B or 1, S, L]. GQA contracts
    grouped against the unrepeated K/V, as the JAX package's einsum does:
    each view is cast to f32 in one copy that also makes it contiguous, and
    the two products are batched matmuls over (B, n_kv) with the keys read
    transposed in place (an einsum over token-major views would copy each f32
    view once more into this layout).

    ``alibi_slopes`` [H] adds BLOOM's position bias ``slope_h * key_pos``
    (``k_positions`` [L] or [B, L], the keys' absolute positions; softmax
    is shift-invariant along a row, so this is the relative
    ``slope * (j - i)`` form), as in the JAX core (reference
    ``models/llama.py:447-476``)."""
    B, S, H, hd = q.shape
    G, L = k_all.shape[1], k_all.shape[2]
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    qg = (q * scale).float().reshape(B, S, G, n_rep, hd).permute(0, 2, 3, 1, 4)
    kf = k_all.to(torch.float32, memory_format=torch.contiguous_format)
    vf = v_all.to(torch.float32, memory_format=torch.contiguous_format)
    logits = torch.matmul(qg.reshape(B, G, n_rep * S, hd), kf.transpose(-1, -2))
    logits = softcap_logits(logits.view(B, G, n_rep, S, L), logit_softcap)
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).view(1, G, n_rep, 1, 1)
        kp = k_positions.to(torch.float32)
        kp = kp.view(1, 1, 1, 1, L) if kp.dim() == 1 else kp.view(B, 1, 1, 1, L)
        logits = logits + slopes * kp
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.view(B, G, n_rep * S, L), vf)  # [B, G, rep * S, hd]
    return out.view(B, G, n_rep, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def update_kv_cache_and_attend(cache, q, k, v, cache_pos, n_rep: int, sliding_window=None,
                               sm_scale=None, logit_softcap=None, alibi_slopes=None):
    """Write this call's K/V into ``cache`` (in place) at ``cache_pos`` and
    attend q against it. Returns (out [B, S, H, hd], cache).

    An int ``cache_pos`` (``generate`` and the decoders) writes every row at
    the same position of a dense or ring cache. Ring caches (``"pos"``
    present) write slot ``pos % capacity``. A multi-token write attends the
    pre-write ring contents concatenated with the chunk, masked by per-slot
    positions; a single-token decode writes one slot and attends the ring
    alone. A tensor ``cache_pos`` [B] (the serving engine) takes
    :func:`_update_slots_and_attend`. ``alibi_slopes`` [H] (BLOOM) adds
    ``slope_h * key_pos`` to the logits, from each key's stored position."""
    if torch.is_tensor(cache_pos):
        return _update_slots_and_attend(cache, q, k, v, cache_pos, n_rep,
                                        sliding_window=sliding_window, sm_scale=sm_scale,
                                        logit_softcap=logit_softcap,
                                        alibi_slopes=alibi_slopes), cache
    if "pos" not in cache:
        S, L = k.shape[1], cache["k"].shape[1]
        if cache_pos + S > L:
            raise ValueError(f"cache of length {L} cannot hold positions "
                             f"[{cache_pos}, {cache_pos + S})")
        cache["k"][:, cache_pos:cache_pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, cache_pos:cache_pos + S] = v.to(cache["v"].dtype)
        out = _cached_attention(q, cache["k"], cache["v"], cache_pos, n_rep,
                                sliding_window=sliding_window, sm_scale=sm_scale,
                                logit_softcap=logit_softcap, alibi_slopes=alibi_slopes)
        return out, cache

    window = cache["k"].shape[1]
    B, S = q.shape[0], q.shape[1]
    if S > 1:
        eff_window = min(sliding_window or window, window)
        k_comb = torch.cat([cache["k"], k.to(cache["k"].dtype)], dim=1)
        v_comb = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
        chunk_pos = cache_pos + torch.arange(S, dtype=torch.int32, device=q.device)
        pos_comb = torch.cat([cache["pos"], chunk_pos.expand(B, S)], dim=1)  # [B, W+S]
        # Ring slots count only for positions strictly BEFORE the chunk: an
        # earlier multi-token write may have left stale entries the chunk
        # supersedes.
        seg_valid = torch.cat(
            [cache["pos"] < cache_pos, torch.ones((B, S), dtype=torch.bool, device=q.device)],
            dim=1)
        pc = pos_comb[:, None, :]
        qp = chunk_pos[None, :, None]
        mask = seg_valid[:, None, :] & (pc >= 0) & (pc <= qp) & (pc > qp - eff_window)
        out = _grouped_cached_attention(q, k_comb.transpose(1, 2), v_comb.transpose(1, 2), mask,
                                        n_rep, sm_scale=sm_scale, logit_softcap=logit_softcap,
                                        alibi_slopes=alibi_slopes, k_positions=pos_comb)
        take = min(S, window)
        idx = cache_pos + torch.arange(S - take, S, dtype=torch.int32, device=q.device)
        slots = (idx % window).long()
        cache["k"][:, slots] = k[:, S - take:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, S - take:].to(cache["v"].dtype)
        cache["pos"][:, slots] = idx.expand(B, take)
        return out, cache

    slot = cache_pos % window
    cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
    cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
    cache["pos"][:, slot] = cache_pos
    out = _ring_cached_attention(q, cache, cache_pos, n_rep,
                                 window=min(sliding_window or window, window),
                                 sm_scale=sm_scale, logit_softcap=logit_softcap,
                                 alibi_slopes=alibi_slopes)
    return out, cache


def _lora_delta(y, x, lora, name):
    """``y`` plus the LoRA delta ``((x @ a) @ b) * scale`` of module ``name``
    of ``lora`` (JAX ``models/llama.py:562``), or ``y`` when ``lora`` does
    not adapt it. Factors with a leading batch dim give each row its own
    adapter (the serving engine's per-slot rows); ``a @ b`` is never
    formed."""
    mod = lora.get(name) if lora else None
    if mod is None:
        return y
    a, b, scale = _lora_factors(mod, x.dtype)
    return y + ((x @ a) @ b) * scale


def _lora_sub(lora, prefix: str):
    """The modules of ``lora`` under ``prefix`` (e.g. ``"self_attn."``),
    with the prefix dropped; None when there are none."""
    if not lora:
        return None
    n = len(prefix)
    sub = {name[n:]: mod for name, mod in lora.items() if name.startswith(prefix)}
    return sub or None


def _lora_layers(lora, num_layers: int) -> list:
    """A model-level adapter (``{"model.layers.<i>.<module>": {...}}``)
    split per decoder layer: a list of ``num_layers`` dicts (or Nones)."""
    if not lora:
        return [None] * num_layers
    per: list = [None] * num_layers
    for name, mod in lora.items():
        parts = name.split(".", 3)
        if len(parts) != 4 or parts[:2] != ["model", "layers"] or not parts[2].isdigit():
            raise ValueError(f"lora module {name!r} is not a decoder-layer projection "
                             "(model.layers.<i>.<module>)")
        i = int(parts[2])
        if per[i] is None:
            per[i] = {}
        per[i][parts[3]] = mod
    return per


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, window: Any = "config", device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        # "config" reads the uniform cfg.sliding_window; LlamaBlock passes
        # cfg.window_for(layer_idx) for Gemma2-style mixtures.
        self.window = cfg.sliding_window if window == "config" else window
        n_q, n_kv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        bias = cfg.attention_qkv_bias
        self.q_proj = _linear(cfg, cfg.hidden_size, n_q * hd, bias, device, dtype)
        self.k_proj = _linear(cfg, cfg.hidden_size, n_kv * hd, bias, device, dtype)
        self.v_proj = _linear(cfg, cfg.hidden_size, n_kv * hd, bias, device, dtype)
        self.o_proj = _linear(cfg, n_q * hd, cfg.hidden_size, cfg.attention_out_bias, device, dtype)

    def forward(self, x, positions, causal=True, cache=None, cache_pos=None, segment_ids=None,
                lora=None):
        cfg = self.config
        B, S, _ = x.shape
        n_q, n_kv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        tp = _tp_group(self.q_proj, n_q * hd)
        if tp is not None:
            return self._tensor_parallel(x, positions, causal, cache, cache_pos, segment_ids,
                                         lora, tp)
        q = _lora_delta(self.q_proj(x), x, lora, "q_proj").reshape(B, S, n_q, hd)
        k = _lora_delta(self.k_proj(x), x, lora, "k_proj").reshape(B, S, n_kv, hd)
        v = _lora_delta(self.v_proj(x), x, lora, "v_proj").reshape(B, S, n_kv, hd)
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta, dtype=x.dtype,
                                    rope_scaling=cfg.rope_scaling)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        sm_scale = None if cfg.query_pre_attn_scalar is None else cfg.sm_scale
        softcap = cfg.attn_logit_softcapping

        if cache is not None:
            out, cache = update_kv_cache_and_attend(
                cache, q, k, v, cache_pos, n_q // n_kv, sliding_window=self.window,
                sm_scale=sm_scale, logit_softcap=softcap)
            out = out.reshape(B, S, n_q * hd)
            return _lora_delta(self.o_proj(out), out, lora, "o_proj"), cache

        out = multi_head_attention(
            q, k, v, causal=causal, use_flash=cfg.use_flash_attention,
            segment_ids=segment_ids, backend=cfg.attention_backend,
            sliding_window=self.window, sm_scale=sm_scale, logit_softcap=softcap)
        out = out.reshape(B, S, n_q * hd)
        return _lora_delta(self.o_proj(out), out, lora, "o_proj")

    def _tensor_parallel(self, x, positions, causal, cache, cache_pos, segment_ids, lora, tp):
        """The forward on this process's heads: q/k/v column parallel
        (``H / tp`` query heads, ``G / tp`` K/V heads), the output
        projection row parallel, a LoRA adapter's factors applied inside
        each (:func:`column_parallel`, :func:`row_parallel`). K/V heads that
        ``tp`` cannot split (``G`` not a multiple of it) are gathered whole:
        without a cache, repeated to this process's query heads; with the
        serving engine's cache, which then holds a slice of ``head_dim``,
        through :func:`_head_dim_split_attend`. With a cache (a tensor
        ``cache_pos``, the serving engine's steps) the cache holds this
        process's K/V heads. Returns what :meth:`forward` returns."""
        cfg = self.config
        B, S, _ = x.shape
        hd = cfg.head_dim
        n_kv = cfg.num_key_value_heads
        h_local = cfg.num_attention_heads // tp.size
        x = _SumGradient.apply(x, tp)  # Megatron's f
        q = column_parallel(self.q_proj, x, tp, _lora_of(lora, "q_proj")).reshape(B, S, h_local, hd)
        k = column_parallel(self.k_proj, x, tp, _lora_of(lora, "k_proj"))
        v = column_parallel(self.v_proj, x, tp, _lora_of(lora, "v_proj"))
        split = n_kv % tp.size == 0
        if split:
            k = k.reshape(B, S, -1, hd)
            v = v.reshape(B, S, -1, hd)
        else:
            k, v = (_GatherSplit.apply(t, tp, 2).reshape(B, S, n_kv, hd) for t in (k, v))
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta, dtype=x.dtype,
                                    rope_scaling=cfg.rope_scaling)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        sm_scale = None if cfg.query_pre_attn_scalar is None else cfg.sm_scale
        softcap = cfg.attn_logit_softcapping
        if cache is not None:
            if not torch.is_tensor(cache_pos):
                raise NotImplementedError(
                    "under tensor parallelism the KV cache is the serving engine's (a "
                    "tensor cache_pos [B]); generate runs on a whole model")
            if split:
                out, cache = update_kv_cache_and_attend(
                    cache, q, k, v, cache_pos, h_local // k.shape[2],
                    sliding_window=self.window, sm_scale=sm_scale, logit_softcap=softcap)
            else:
                out = _head_dim_split_attend(cache, q, k, v, cache_pos, tp,
                                             sliding_window=self.window, sm_scale=sm_scale,
                                             logit_softcap=softcap)
        else:
            if not split:
                rep = cfg.num_attention_heads // n_kv
                k, v = (t.repeat_interleave(rep, dim=2).narrow(2, tp.index * h_local, h_local)
                        for t in (k, v))
            out = multi_head_attention(
                q, k, v, causal=causal, use_flash=cfg.use_flash_attention,
                segment_ids=segment_ids, backend=cfg.attention_backend,
                sliding_window=self.window, sm_scale=sm_scale, logit_softcap=softcap)
        out = row_parallel(self.o_proj, out.reshape(B, S, h_local * hd), tp,
                           _lora_of(lora, "o_proj"))
        return out if cache is None else (out, cache)


def _lora_of(lora, name: str):
    """Module ``name`` of ``lora``, or None."""
    return lora.get(name) if lora else None


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = config
        if cfg.mlp_activation not in ("silu", "gelu_tanh", "gelu_exact"):
            raise NotImplementedError(f"mlp_activation {cfg.mlp_activation!r}")
        self.activation = cfg.mlp_activation
        self.intermediate_size = cfg.intermediate_size
        self.gate_proj = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, False, device, dtype)
        self.up_proj = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, False, device, dtype)
        self.down_proj = _linear(cfg, cfg.intermediate_size, cfg.hidden_size, False, device, dtype)

    def _act(self, gate):
        if self.activation == "gelu_tanh":     # GeGLU, tanh approx (Gemma)
            return F.gelu(gate, approximate="tanh")
        if self.activation == "gelu_exact":    # GeGLU, exact erf
            return F.gelu(gate)
        return F.silu(gate)                    # SwiGLU (Llama et al.)

    def forward(self, x, lora=None):
        tp = _tp_group(self.gate_proj, self.intermediate_size)
        if tp is not None:
            x = _SumGradient.apply(x, tp)
            h = (self._act(column_parallel(self.gate_proj, x, tp, _lora_of(lora, "gate_proj")))
                 * column_parallel(self.up_proj, x, tp, _lora_of(lora, "up_proj")))
            return row_parallel(self.down_proj, h, tp, _lora_of(lora, "down_proj"))
        gate = _lora_delta(self.gate_proj(x), x, lora, "gate_proj")
        h = self._act(gate) * _lora_delta(self.up_proj(x), x, lora, "up_proj")
        return _lora_delta(self.down_proj(h), h, lora, "down_proj")


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, layer_idx: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = config
        self.post_norms = cfg.post_norms

        def norm():
            return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.rms_norm_unit_offset,
                           device=device, dtype=dtype)

        self.input_norm = norm()
        self.self_attn = LlamaAttention(cfg, window=cfg.window_for(layer_idx), device=device,
                                        dtype=dtype)
        self.post_attn_norm = norm()
        if cfg.post_norms:
            self.pre_ffn_norm = norm()
            self.post_ffn_norm = norm()
        self.mlp = LlamaMLP(cfg, device=device, dtype=dtype)

    def forward(self, x, positions, cache=None, cache_pos=None, segment_ids=None, lora=None):
        attn = self.self_attn(self.input_norm(x), positions, cache=cache, cache_pos=cache_pos,
                              segment_ids=segment_ids, lora=_lora_sub(lora, "self_attn."))
        if cache is not None:
            attn, cache = attn
        mlp_lora = _lora_sub(lora, "mlp.")
        if self.post_norms:
            # Gemma2 sandwich block: sublayer OUTPUTS are normed before their
            # residual adds, and the MLP gets its own pre-norm.
            h = x + self.post_attn_norm(attn)
            h = h + self.post_ffn_norm(self.mlp(self.pre_ffn_norm(h), lora=mlp_lora))
        else:
            h = x + attn
            h = h + self.mlp(self.post_attn_norm(h), lora=mlp_lora)
        return h if cache is None else (h, cache)


def _run_layer(layer: nn.Module, params: dict, x, positions, segment_ids, lora=None,
               gather=None, buffers=None):
    """One decoder layer through ``functional_call`` on ``params``, put
    together first by ``gather`` (a sharded layout's, or None), and
    ``buffers`` (a stacked layer's slices of its fp8 statistics, which its
    backward writes into) as they are."""
    if gather is not None:
        params = gather(params)
    if buffers:
        params = {**params, **buffers}
    return torch.func.functional_call(layer, params, (x, positions),
                                      {"segment_ids": segment_ids, "lora": lora})


# The _KeptProducts of the "dots" layer that runs now (its forward or its
# recompute), else None. A global, not a thread-local: on the card the
# autograd engine runs the recompute on its own thread.
_kept_products = None


class _KeptProducts:
    """The projections' outputs of one "dots"-checkpointed layer call: its
    forward stores them in order, and its recompute in the backward takes
    them back in the same order instead of multiplying again."""

    def __init__(self):
        self.outputs = []
        self.recomputing = False
        self.taken = 0

    def run(self, fn, *args):
        """``fn(*args)`` (one layer call) with this object's products kept."""
        global _kept_products
        outer, _kept_products = _kept_products, self
        self.taken = 0
        try:
            return fn(*args)
        finally:
            _kept_products = outer

    def product(self, compute):
        if not self.recomputing:
            out = compute()
            self.outputs.append(out.detach())
            return out
        if self.taken >= len(self.outputs) or self.outputs[self.taken] is None:
            raise RuntimeError(
                'a remat_policy="dots" layer was recomputed twice; a second backward through '
                'it (retain_graph=True) needs remat_policy="nothing"')
        out, self.outputs[self.taken] = self.outputs[self.taken], None
        self.taken += 1
        return out


class _KeptProduct(torch.autograd.Function):
    """``F.linear`` whose output comes from ``kept`` (:class:`_KeptProducts`):
    computed and stored in the layer's forward, taken back in its recompute.
    The backward is ``F.linear``'s, product for product."""

    @staticmethod
    def forward(ctx, x, weight, bias, kept):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return kept.product(lambda: F.linear(x, weight, bias))

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        grad2d = grad.reshape(-1, grad.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (grad2d @ weight).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (x.reshape(-1, x.shape[-1]).T @ grad2d).T
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = grad2d.sum(0)
        return dx, dw, db, None


def _remat_layer(layer: nn.Module, params: dict, x, positions, segment_ids,
                 policy: str = "nothing", lora=None, gather=None, gather_inside: bool = False,
                 buffers=None):
    """One decoder layer under ``torch.utils.checkpoint`` (non-reentrant):
    what ``policy`` (a :func:`resolve_remat_policy` name) does not keep is
    recomputed in the backward. "dots" stores the projections' outputs in a
    :class:`_KeptProducts` and the recompute takes them back, so it runs
    everything but the products again; torch's selective checkpointing
    would decide the same op by op, through a Python dispatch mode that
    costs more host time than the products save. The layer's parameters go
    in by value (``params``), so the recompute uses the tensors this
    forward used, also when the forward ran inside a ``functional_call``
    that has ended by the time the backward runs.

    ``gather`` puts a sharded layer's parameters together: outside the
    checkpoint (the gathered weights are kept for the backward), or with
    ``gather_inside`` inside it, so the recompute gathers again and only
    the chunks are kept (FSDP's reshard after forward)."""
    if gather is not None and not gather_inside:
        params, gather = gather(params), None
    rule = resolve_remat_policy(policy)
    if rule is RematPolicy.EVERYTHING:
        return _run_layer(layer, params, x, positions, segment_ids, lora, gather, buffers)
    if rule is RematPolicy.NOTHING:
        return checkpoint(_run_layer, layer, params, x, positions, segment_ids, lora, gather,
                          buffers, use_reentrant=False)
    kept = _KeptProducts()
    out = checkpoint(kept.run, _run_layer, layer, params, x, positions, segment_ids, lora,
                     gather, buffers, use_reentrant=False)
    kept.recomputing = True
    return out


def _layout_of(module: nn.Module):
    """The sharded layout (``parallel/sharding.py``) the accelerator
    attached to ``module``, and the module's name prefix in it."""
    return getattr(module, "_sharded_layout", None), getattr(module, "_layout_prefix", "")


def _remat_of(config, layout) -> Optional[str]:
    """The remat policy of a training forward: a sharded layout's (the FSDP
    plugin's activation checkpointing), else the config's, else None."""
    if layout is not None and layout.remat_policy is not None:
        return layout.remat_policy
    return config.remat_policy if config.remat else None


def _default_positions(input_ids, start=0):
    """Positions ``start + i``; a tensor ``start`` [B] gives each row its own."""
    B, S = input_ids.shape
    steps = torch.arange(S, device=input_ids.device)
    if torch.is_tensor(start):
        return start[:, None] + steps
    return (start + steps)[None, :].expand(B, S)


def _cp_start(seq: int) -> int:
    """Where this process's chunk of each row starts on a mesh whose
    ``cp`` axis splits the sequence (0 without one): rotary takes global
    positions."""
    from ..parallel.mesh import axis_group

    cp = axis_group("cp")
    return 0 if cp is None else cp.index * seq


def _scale_embeddings(cfg: LlamaConfig, x):
    if not cfg.scale_embeddings:
        return x
    # Gemma: the sqrt(hidden) scalar is rounded to the activations' dtype.
    return x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=x.device)


class LlamaModel(nn.Module):
    """Decoder stack without head."""

    #: Where a sharded layout gathers one decoder layer at a time.
    _layer_prefixes = ("layers.",)

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, layer_idx=i, device=device, dtype=dtype)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.rms_norm_unit_offset,
                            device=device, dtype=dtype)

    def forward(self, input_ids, positions=None, cache=None, cache_pos=None, segment_ids=None,
                lora=None):
        """``lora``: an adapter (``adapters/lora.py``) applied to its
        projections, or None."""
        if positions is None:
            positions = _default_positions(
                input_ids, _cp_start(input_ids.shape[1]) if cache_pos is None else cache_pos)
        if segment_ids is not None and cache is not None:
            raise ValueError(
                "segment_ids (packed sequences) is a training feature; the "
                "KV-cache decode path does not apply segment masking")
        x = _scale_embeddings(self.config, _embed(self.config, self.embed_tokens, input_ids))
        layout, prefix = _layout_of(self)
        policy = _remat_of(self.config, layout)
        remat = policy is not None and cache is None and torch.is_grad_enabled()
        per_layer = _lora_layers(lora, len(self.layers))
        for i, layer in enumerate(self.layers):
            gather = None if layout is None else functools.partial(
                layout.gather_layer, f"{prefix}layers.{i}.")
            if remat:
                x = _remat_layer(layer, dict(layer.named_parameters()), x, positions,
                                 segment_ids, policy, per_layer[i], gather,
                                 layout is not None and layout.gather_in_remat)
            elif gather is not None and cache is None:
                x = _run_layer(layer, dict(layer.named_parameters()), x, positions, segment_ids,
                               per_layer[i], gather)
            elif cache is None:
                x = layer(x, positions, segment_ids=segment_ids, lora=per_layer[i])
            else:
                x, cache[i] = layer(x, positions, cache=cache[i], cache_pos=cache_pos,
                                    lora=per_layer[i])
        x = self.norm(x)
        return x if cache is None else (x, cache)


def _embed(cfg: LlamaConfig, embed_tokens: nn.Embedding, input_ids):
    """The embedding rows of ``input_ids``; a table split on the hidden dim
    over ``tp`` (a tensor-parallel serving shard) gathers its rows whole."""
    x = embed_tokens(input_ids)
    weight = getattr(embed_tokens, "weight", None)
    tp = None if weight is None else _split_group(weight.shape[1], cfg.hidden_size,
                                                  "the embedding table")
    return x if tp is None else _GatherSplit.apply(x, tp, x.dim() - 1)


def _lm_head(cfg: LlamaConfig, x, embedding, lm_head):
    """Logits of the normed hidden states ``x``. Under a tensor-parallel
    serving shard the head holds this process's vocabulary rows (its
    logits are gathered whole), and a tied table its hidden columns (the
    partial products are summed)."""
    if cfg.tie_word_embeddings:
        tp = _split_group(embedding.shape[1], cfg.hidden_size, "the embedding table")
        if tp is None:
            logits = x @ embedding.to(x.dtype).T
        else:
            k = embedding.shape[1]
            logits = _ReduceFromTP.apply(x.narrow(-1, tp.index * k, k)
                                         @ embedding.to(x.dtype).T, tp)
    else:
        logits = lm_head(x)
        weight = getattr(lm_head, "weight", None)
        tp = None if weight is None else _split_group(weight.shape[0], cfg.vocab_size, "lm_head")
        if tp is not None:
            logits = _GatherSplit.apply(logits, tp, logits.dim() - 1)
    return softcap_logits(logits, cfg.final_logit_softcapping)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Random weights from ``generator``: every projection and embedding
    weight ~ N(0, 1/fan_in) (fan_in = the last dim), biases zero, norm
    scales at identity (1, or 0 under ``unit_offset``)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(0.0 if getattr(module.config, "rms_norm_unit_offset", False) else 1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)


class LlamaForCausalLM(nn.Module):
    """Llama-family causal LM. Built on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``) in ``dtype``. ``generator``
    draws random weights (:func:`init_weights`); otherwise load them, e.g.
    ``load_state_dict(state_dict_from_flax(params, config))``."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.model = LlamaModel(config, device=device, dtype=dtype)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False,
                                     device=device, dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, input_ids, positions=None, cache=None, cache_pos=None,
                return_hidden=False, segment_ids=None, lora=None):
        x = self.model(input_ids, positions, cache=cache, cache_pos=cache_pos,
                       segment_ids=segment_ids, lora=lora)
        if cache is not None:
            x, cache = x
        if not return_hidden:
            # return_hidden: the pre-head normed hidden states.
            x = _lm_head(self.config, x, self.model.embed_tokens.weight,
                         getattr(self, "lm_head", None))
        return x if cache is None else (x, cache)


class PipelinedLlamaForCausalLM(nn.Module):
    """Llama with its decoder blocks *stacked*: every block parameter
    carries a leading ``[num_layers, ...]`` dim (``model.blocks.*``), the
    layout of the JAX ``PipelinedLlamaForCausalLM``. The forward applies the
    blocks through ``parallel/pipeline.py``'s ``pipeline_apply``: the GPipe
    schedule over ``num_microbatches`` (default the pipeline plugin's, else
    ``pp``) when the accelerator has split the stacked leaves over a ``pp``
    axis (each process holding its stage's layers), a plain loop over the
    layers otherwise. Uniform windows only, as in JAX."""

    #: Where a sharded layout gathers one decoder layer at a time.
    _layer_prefixes = ("model.blocks.",)

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 num_microbatches: Optional[int] = None):
        super().__init__()
        if config.layer_windows is not None and len(set(config.layer_windows)) > 1:
            raise NotImplementedError(
                "PipelinedLlamaForCausalLM applies one block over stacked params; "
                "heterogeneous per-layer windows (layer_windows) need the "
                "sequential LlamaForCausalLM")
        device = resolve_device(device)
        self.config = config
        self.num_microbatches = num_microbatches
        L = config.num_hidden_layers
        blocks = LlamaBlock(config, device=device, dtype=dtype)
        for name, p in list(blocks.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            setattr(blocks.get_submodule(owner_name), leaf,
                    nn.Parameter(torch.empty((L, *p.shape), device=device, dtype=dtype)))
        # The fp8 statistics (use_fp8) stack too: [L] scales, [L, history].
        for name, b in list(blocks.named_buffers()):
            owner_name, _, leaf = name.rpartition(".")
            owner = blocks.get_submodule(owner_name)
            owner.register_buffer(leaf, b.expand(L, *b.shape).clone(),
                                  persistent=leaf not in owner._non_persistent_buffers_set)
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                               device=device, dtype=dtype)
        self.model.blocks = blocks
        self.model.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                  config.rms_norm_unit_offset, device=device, dtype=dtype)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False,
                                     device=device, dtype=dtype)
        if generator is not None:
            init_weights(self, generator)

    @staticmethod
    def from_sequential_params(state_dict):
        """``LlamaForCausalLM`` state dict (``model.layers.<i>.*``) -> the
        stacked layout (``model.blocks.*`` with a leading layer dim)."""
        per_name, out = {}, {}
        for name, tensor in state_dict.items():
            parts = name.split(".", 3)
            if len(parts) == 4 and parts[:2] == ["model", "layers"] and parts[2].isdigit():
                per_name.setdefault(parts[3], {})[int(parts[2])] = tensor
            else:
                out[name] = tensor
        for name, layers in per_name.items():
            if sorted(layers) != list(range(len(layers))):
                raise ValueError(f"non-contiguous layer indices for {name}: {sorted(layers)}")
            out[f"model.blocks.{name}"] = torch.stack([layers[i] for i in range(len(layers))])
        return out

    @staticmethod
    def to_sequential_params(state_dict):
        """Inverse of :meth:`from_sequential_params`."""
        out = {}
        for name, tensor in state_dict.items():
            if name.startswith("model.blocks."):
                for i in range(tensor.shape[0]):
                    out[f"model.layers.{i}.{name[len('model.blocks.'):]}"] = tensor[i]
            else:
                out[name] = tensor
        return out

    def _microbatches(self) -> Optional[int]:
        if self.num_microbatches is not None:
            return self.num_microbatches
        from ..state import AcceleratorState

        plugin = AcceleratorState._shared_state.get("pp_plugin")
        if plugin is not None and plugin.num_microbatches > 1:
            return plugin.num_microbatches
        return None

    def forward(self, input_ids, positions=None, segment_ids=None, return_hidden=False):
        from ..parallel.mesh import axis_group
        from ..parallel.pipeline import pipeline_apply

        if positions is None:
            positions = _default_positions(input_ids, _cp_start(input_ids.shape[1]))
        x = _scale_embeddings(self.config, self.model.embed_tokens(input_ids))
        stacked = dict(self.model.blocks.named_parameters())
        layout, prefix = _layout_of(self)
        gather = None
        if layout is not None:
            # Each layer's slice is gathered in the loop; a leaf split over
            # the layer axis itself by fsdp is put together here.
            stacked = layout.gather_stacked(f"{prefix}model.blocks.", stacked)
            gather = functools.partial(layout.gather_layer, f"{prefix}model.blocks.",
                                       stacked=True)
        pp = axis_group("pp")
        split = next(iter(stacked.values())).shape[0] != self.config.num_hidden_layers
        if pp is not None and not split:
            raise ValueError(
                f"a pp axis of {pp.size} needs the stacked layers split over it: prepare the "
                "model with a PipelineParallelPlugin")
        policy = _remat_of(self.config, layout)
        remat = policy is not None and torch.is_grad_enabled()
        blocks = self.model.blocks
        gather_inside = layout is not None and layout.gather_in_remat
        # Each layer's slices of the stacked fp8 statistics ride beside its
        # parameters (views: its backward records its amaxes in place).
        buffers = dict(blocks.named_buffers())

        def block_fn(params, h, extras):
            pos, seg = extras
            own = {name: params.pop(name) for name in buffers}
            if remat:
                return _remat_layer(blocks, params, h, pos, seg, policy, None, gather,
                                    gather_inside, own)
            return _run_layer(blocks, params, h, pos, seg, gather=gather, buffers=own)

        x = pipeline_apply(block_fn, {**stacked, **buffers}, x, (positions, segment_ids),
                           num_microbatches=self._microbatches())
        x = self.model.norm(x)
        if return_hidden:
            return x
        return _lm_head(self.config, x, self.model.embed_tokens.weight,
                        getattr(self, "lm_head", None))


def _targets_and_mask(batch):
    """Shared label semantics of every causal-LM loss: the next-token shift
    when there are no explicit ``labels``, -100 = ignored (HF convention).
    Returns (safe targets, float mask) with the -100 slots zeroed."""
    targets = batch.get("labels")
    if targets is None:
        targets = F.pad(batch["input_ids"][:, 1:], (0, 1), value=-100)
    mask = (targets != -100).float()
    safe = torch.where(targets == -100, torch.zeros_like(targets), targets)
    return safe.long(), mask


def _masked_ce(logits, safe, mask):
    """The mean cross-entropy in f32 of ``logits`` against ``safe`` targets
    over the labels ``mask`` keeps."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def masked_next_token_ce(logits, batch):
    """Next-token cross-entropy over a batch with optional ``labels`` (-100 =
    ignored), in f32. Shared by the causal-LM loss factories."""
    return _masked_ce(logits, *_targets_and_mask(batch))


def _forward_kwargs(batch):
    # Packed-sequence batches carry per-token positions and segment ids;
    # plain batches do not. Forwarded so documents never attend across
    # each other.
    return {name: batch[name] for name in ("positions", "segment_ids") if name in batch}


def _loss_inputs(batch):
    """``(input_ids, forward kwargs, safe targets, mask)`` of a loss: the
    targets of whole rows, then, on a mesh whose ``cp`` axis splits the
    sequence, this process's chunk of each (with global positions)."""
    from ..state import current_mesh

    safe, mask = _targets_and_mask(batch)
    ids, kwargs = batch["input_ids"], _forward_kwargs(batch)
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("cp", 1) > 1:
        S, n = ids.shape[1], mesh.shape["cp"]
        if S % n:
            raise ValueError(f"sequence length {S} not divisible by cp={n}")
        cp = mesh.group("cp")
        k = S // cp.size
        kwargs.setdefault("positions", _default_positions(ids))
        cut = slice(cp.index * k, (cp.index + 1) * k)
        kwargs = {name: t[:, cut] for name, t in kwargs.items()}
        ids, safe, mask = ids[:, cut], safe[:, cut], mask[:, cut]
    return ids, kwargs, safe, mask


def _module(model):
    """The ``nn.Module`` under a prepared model (``AcceleratedModel.module``)."""
    return getattr(model, "module", model)


def causal_lm_loss(model):
    """``loss_fn(params, batch, rng=None)`` for ``compile_train_step``:
    next-token cross-entropy over the full logits. ``params`` maps parameter
    names of ``model`` to tensors (e.g. compute-cast copies); ``batch`` holds
    ``input_ids`` and optional ``labels``, ``positions``, ``segment_ids``."""
    module = _module(model)

    def loss_fn(params, batch, rng=None):
        ids, kwargs, safe, mask = _loss_inputs(batch)
        logits = torch.func.functional_call(module, params, (ids,), kwargs)
        return _masked_ce(logits, safe, mask)

    return loss_fn


def fused_causal_lm_loss(module, num_chunks: int = 8):
    """Memory-efficient :func:`causal_lm_loss`: the [tokens, vocab] logits
    are never materialized; the LM head runs chunked over the vocabulary
    with an online softmax (``ops/fused_loss.py``), final-logit softcap
    included. ``module`` is a ``LlamaForCausalLM`` or a
    ``PipelinedLlamaForCausalLM`` (or either, prepared).

    The loss is the mean over this call's labels (on a ``cp`` mesh, over
    this process's chunk of each row, :func:`_loss_inputs`), and the call
    communicates nothing. ``loss_fn.label_count(batch)`` gives that label
    count, which the accelerator reads in a process group: its train step
    and ``backward`` all-reduce the count and weight each process's loss by
    its share of the global count, so the gradients, summed across
    processes, are those of the global batch's mean, as in the JAX package,
    where the batch is one array over every process. The mean of the
    processes' means would differ wherever they hold different numbers of
    unmasked labels (packed rows)."""
    from ..ops.fused_loss import chunked_softmax_xent

    module = _module(module)
    cfg = module.config

    def loss_fn(params, batch, rng=None):
        ids, kwargs, safe, mask = _loss_inputs(batch)
        h = torch.func.functional_call(module, params, (ids,), {"return_hidden": True, **kwargs})
        if cfg.tie_word_embeddings:
            kernel = params["model.embed_tokens.weight"].T
        else:
            kernel = params["lm_head.weight"].T  # [hidden, vocab], the flax layout
        B, S, H = h.shape
        return chunked_softmax_xent(h.reshape(B * S, H), kernel.to(h.dtype), safe.reshape(-1),
                                    mask.reshape(-1), num_chunks, cfg.final_logit_softcapping)

    loss_fn.label_count = lambda batch: _loss_inputs(batch)[3].sum()
    return loss_fn
