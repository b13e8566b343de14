"""Big-model inference: run models larger than the card's memory.

Counterpart of ``accelerate_tpu/big_modeling.py`` (its Llama and Mixtral
families, the GPT-style ones: GPT-2, OPT, GPT-J, GPT-NeoX, Phi, BLOOM, and
the encoder-decoder T5). The design is the JAX package's: the model is
split into an embed block, one block per decoder layer and a head block (T5:
an encoder stage run once per input, then a decoder stage, the only one a
decode step runs), and the weights of each block live on the card, in host
memory or on disk, as a device map says.

* "Meta device" init: :func:`init_empty_weights` builds the model on the
  meta device, where it holds shapes and no memory.
* Device-map solver: ``utils/modeling.infer_auto_device_map`` over card,
  host and disk.
* Block-streaming executor (:class:`StreamedModel`): the layer blocks of
  one kind share one ``LlamaBlock`` built on the meta device, and each runs
  through ``torch.func.functional_call`` with the tensors fetched for it,
  so nothing is copied into module parameters. A worker thread fetches the
  next block's weights onto the card on a side CUDA stream while the
  current block computes; the compute stream waits on an event recorded
  after the copy. A block whose weights all live on the card is fetched
  once and kept. Peak card memory is the resident weights plus twice the
  largest streamed block (double buffering): the fetch of block ``i + 1``
  waits until block ``i - 1`` has finished computing.
* Host tier: tensors are pinned once at load, so each host-to-card copy is
  asynchronous; a host tensor that is not pinned raises when it is fetched
  for the card, where its copy would silently be synchronous.
* Disk tier: :class:`LazyWeight` keeps a reference into the original
  safetensors shard (its byte offsets, the header parsed once) or into a
  memmap copy (``utils/offload.py``); a fetch reads it into pinned staging,
  then copies it to the card. An HF MoE checkpoint stores each expert's
  matrix apart: :class:`LazyStack` keeps the references to a stacked
  expert leaf's members (each transposed on read) and stacks them only when
  its block is fetched, so no tier holds more than a block of experts.

Device maps name placements by the port's parameter names
(``model.layers.<i>.self_attn.q_proj.weight``). Integer placements name
``cuda:<i>``; with ``execution_device="cpu"`` (the tests), they resolve to
that device. Entry points run on the card unless the caller asks for the
CPU, and raise without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from .checkpointing import SafetensorsFile, checkpoint_shards
from .utils.device import resolve_device
from .utils.modeling import (
    DeviceId,
    check_device_map,
    get_balanced_memory,
    infer_auto_device_map,
    named_parameters,
)


# ---------------------------------------------------------------------------
# Meta-device initialization
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def init_on_device(device, include_buffers: Optional[bool] = None):
    """Tensors made inside the context default to ``device``, and so do the
    port's models built without a ``device=`` (``utils/device.py``).
    ``include_buffers`` is accepted for the reference's signature: the
    context places buffers and parameters alike."""
    del include_buffers
    with torch.device(device):
        yield


def init_empty_weights(include_buffers: Optional[bool] = None):
    """Context in which models are built on the meta device: the tree of
    shapes and dtypes the loaders and the device-map solver need, with no
    memory behind it."""
    return init_on_device(torch.device("meta"), include_buffers)


# ---------------------------------------------------------------------------
# Weight store: flat name -> tensor on the card or the host, or a lazy ref
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LazyWeight:
    """A tensor still on disk: a member of a safetensors shard (``source``,
    its header parsed once) or a raw offload memmap (``memmap_info``,
    ``utils/offload.py``). Read only when its block is fetched, then cast to
    ``dtype`` where one is given."""

    path: str
    key: str
    dtype: Optional[torch.dtype] = None
    memmap_info: Optional[dict] = None
    source: Optional[SafetensorsFile] = None
    transform: Optional[str] = None  # "t": transposed on read (an HF router)

    @property
    def nbytes(self) -> int:
        """Bytes of the tensor once fetched (after the cast)."""
        if self.memmap_info is not None:
            import numpy as np

            shape = self.memmap_info["shape"]
            itemsize = np.dtype(self.memmap_info["dtype"]).itemsize
        else:
            source = self.source if self.source is not None else SafetensorsFile(self.path)
            dtype, shape, _ = source.meta(self.key)
            itemsize = dtype.itemsize
        if self.dtype is not None:
            itemsize = self.dtype.itemsize
        return math.prod(shape) * itemsize

    def load(self, pin: bool = False) -> torch.Tensor:
        """The tensor in host memory in its stored dtype, pinned when
        ``pin`` (the staging of a copy to the card)."""
        if self.memmap_info is not None:
            from .utils.offload import load_offloaded_weight

            t = load_offloaded_weight(self.path, self.memmap_info)
            return _staged(t) if pin else t
        source = self.source if self.source is not None else SafetensorsFile(self.path)
        if self.transform is None:
            return source.read(self.key, pin=pin)
        from .utils.hf_interop import apply_op

        t = apply_op(source.read(self.key), self.transform)
        return _staged(t) if pin else t


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t``."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


@dataclasses.dataclass
class LazyStack:
    """A stacked leaf whose members are still on disk (a Mixtral layer's
    experts: E per-expert matrices -> one ``[E, in, out]`` parameter):
    ``members`` are their :class:`LazyWeight` s in stack order, each
    transposed on read. Read and stacked only when its block is fetched,
    then cast to ``dtype`` where one is given."""

    members: list
    dtype: Optional[torch.dtype] = None

    @property
    def nbytes(self) -> int:
        return sum(m.nbytes for m in self.members)

    def load(self, pin: bool = False) -> torch.Tensor:
        """The stacked tensor in host memory in its stored dtype, pinned
        when ``pin``."""
        t = torch.stack([m.load() for m in self.members])
        return _staged(t) if pin else t


class WeightStore:
    """Flat ``{parameter name: entry}`` with a placement per name. Entries
    are tensors on the card or on the host, or :class:`LazyWeight`."""

    def __init__(self):
        self.entries: dict = {}
        self.placement: dict = {}

    def put(self, name: str, value, device: DeviceId):
        """Store a tensor under ``name`` on the given placement tier."""
        self.placement[name] = device
        self.entries[name] = value

    def names_under(self, prefix: str) -> list:
        """All stored parameter names with this prefix."""
        return [n for n in self.entries if n == prefix or n.startswith(prefix + ".")]

    def fetch_subtree(self, prefix: str, device=None) -> dict:
        """The tensors under ``prefix``, by their names relative to it
        (``functional_call``'s flat form of the JAX package's nested
        subtree), on ``device`` where one is given: disk entries are read
        (and cast), host and card entries pass through or are copied."""
        out = {}
        for name in self.names_under(prefix):
            rel = name[len(prefix) + 1:] if name != prefix else name.rsplit(".", 1)[-1]
            val = self.entries[name]
            if isinstance(val, (LazyWeight, LazyStack)):
                val = val.load() if val.dtype is None else val.load().to(val.dtype)
            out[rel] = val if device is None else val.to(device)
        return out

    def total_bytes(self, kind: Optional[str] = None) -> int:
        """Bytes held in memory, of one kind (``"device"`` or ``"cpu"``) or
        both; lazy disk entries count 0."""
        total = 0
        for name, val in self.entries.items():
            if isinstance(val, (LazyWeight, LazyStack)):
                continue
            k = "cpu" if self.placement.get(name) == "cpu" else "device"
            if kind is None or k == kind:
                total += val.numel() * val.element_size()
        return total


# ---------------------------------------------------------------------------
# Block specs: how a model family splits into streamable blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockSpec:
    """One streamable unit. ``apply(ptrees, *args) -> args`` where
    ``ptrees`` is a tuple of ``{relative name: tensor}``, one per prefix in
    order; blocks of one ``kind`` share one module. ``cached_apply(ptrees,
    args, cache, pos) -> (args, cache)`` is the KV-cached form, ``cache``
    this block's layer cache (None when ``cache_slot`` is False) and ``pos``
    the write position. An encoder-decoder model tags its blocks ``stage``
    "enc" or "dec", so the executor runs the encoder once and loops only
    the decoder while generating."""

    name: str
    prefixes: tuple
    apply: Callable
    kind: str = "unique"
    cached_apply: Optional[Callable] = None
    stage: str = "main"
    cache_slot: bool = False


def block_specs_for(module) -> Optional[list]:
    """Block specs of a shipped model family, or None for another
    architecture (the caller passes specs)."""
    from .models.llama import LlamaForCausalLM
    from .models.mixtral import MixtralForCausalLM
    from .models.t5 import T5ForConditionalGeneration

    if isinstance(module, LlamaForCausalLM):
        return _llama_block_specs(module.config)
    if isinstance(module, MixtralForCausalLM):
        return _mixtral_block_specs(module.config)
    if isinstance(module, T5ForConditionalGeneration):
        return _t5_block_specs(module.config)
    for cls, builder in _gptlike_specs():
        if isinstance(module, cls):
            return builder(module.config)
    return None


def _llama_block_specs(cfg) -> list:
    """Embed, one block per decoder layer and the head, in the port's
    names. The computation is ``LlamaForCausalLM.forward``'s, op for op, so
    a streamed forward gives the resident model's logits."""
    from .models.llama import LlamaBlock

    return _decoder_block_specs(cfg, LlamaBlock, "model.", has_aux=False)


def _mixtral_block_specs(cfg) -> list:
    """``MixtralForCausalLM``'s blocks: its names have no ``model.`` scope,
    and its blocks return ``(x, aux)`` (the router losses, dropped at
    inference). Stacked expert leaves from per-expert HF tensors arrive as
    :class:`LazyStack` s."""
    from .models.mixtral import MixtralBlock

    return _decoder_block_specs(cfg, MixtralBlock, "", has_aux=True)


def _decoder_block_specs(cfg, block_cls, scope: str, has_aux: bool) -> list:
    """Embed, one block per decoder layer and the head of a decoder-only
    model whose names sit under ``scope``; blocks of one kind (window, and
    for Mixtral a dense MLP) share one meta ``block_cls``."""
    from .models.llama import RMSNorm, _default_positions, _lm_head, _scale_embeddings

    call = torch.func.functional_call
    shared: dict = {}  # kind -> the meta block its blocks run through
    norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.rms_norm_unit_offset, device="meta")

    def embed(ptrees, input_ids, pos):
        x = _scale_embeddings(cfg, F.embedding(input_ids, ptrees[0]["weight"]))
        return x, _default_positions(input_ids, pos)

    def head(ptrees, x, positions):
        h = call(norm, ptrees[0], (x,))
        w = ptrees[1]["weight"]
        return (_lm_head(cfg, h, w, lambda t: F.linear(t, w)),)

    def layer_fns(block):
        def apply(ptrees, x, positions):
            out = call(block, ptrees[0], (x, positions))
            return (out[0] if has_aux else out), positions

        def cached(ptrees, args, cache, pos):
            out = call(block, ptrees[0], args, {"cache": cache, "cache_pos": pos})
            return (out[0], args[1]), out[-1]

        return apply, cached

    specs = [BlockSpec("embed", (f"{scope}embed_tokens",), lambda p, ids: embed(p, ids, 0),
                       kind="embed",
                       cached_apply=lambda p, args, cache, pos: (embed(p, args[0], pos), None))]
    for i in range(cfg.num_hidden_layers):
        window = cfg.window_for(i)
        kind = "layer" if window is None else f"layer_w{window}"
        if i in getattr(cfg, "mlp_only_layers", ()):
            kind += "_dense"
        if kind not in shared:
            shared[kind] = block_cls(cfg, layer_idx=i, device="meta")
        apply, cached = layer_fns(shared[kind])
        specs.append(BlockSpec(f"layers.{i}", (f"{scope}layers.{i}",), apply, kind=kind,
                               cached_apply=cached, cache_slot=True))
    head_prefixes = (f"{scope}norm", f"{scope}embed_tokens" if cfg.tie_word_embeddings
                     else "lm_head")
    specs.append(BlockSpec("head", head_prefixes, head, kind="head",
                           cached_apply=lambda p, args, cache, pos: (head(p, *args), None)))
    return specs


def _gptlike_block_specs(cfg, block_cls, layer_fmt: str, embed_prefixes: tuple, embed_fn,
                         head_prefixes: tuple, head_fn) -> list:
    """Embed, one block per layer and the head of a GPT-style family
    (reference ``_gptlike_block_specs``): its blocks take ``x`` and compute
    their own positions from ``cache_pos``, so only the embedding and the
    head differ between families. Every layer runs through one meta
    ``block_cls``; ``embed_fn(ptrees, ids, pos)`` and ``head_fn(ptrees, x)``
    compute what the model's forward does, op for op."""
    call = torch.func.functional_call
    block = block_cls(cfg, device="meta")

    def layer(ptrees, x):
        return (call(block, ptrees[0], (x,)),)

    def layer_cached(ptrees, args, cache, pos):
        x, cache = call(block, ptrees[0], args, {"cache": cache, "cache_pos": pos})
        return (x,), cache

    specs = [BlockSpec("embed", embed_prefixes, lambda p, ids: (embed_fn(p, ids, 0),),
                       kind="embed",
                       cached_apply=lambda p, args, cache, pos: ((embed_fn(p, args[0], pos),),
                                                                 None))]
    for i in range(cfg.num_hidden_layers):
        name = layer_fmt.format(i=i)
        specs.append(BlockSpec(name, (name,), layer, kind="layer", cached_apply=layer_cached,
                               cache_slot=True))
    specs.append(BlockSpec("head", head_prefixes, lambda p, x: (head_fn(p, x),), kind="head",
                           cached_apply=lambda p, args, cache, pos: ((head_fn(p, args[0]),),
                                                                     None)))
    return specs


def _layer_norm(eps: float, hidden: int):
    """``norm(tree, x)``: a meta ``models.llama.LayerNorm`` run on the
    tensors ``tree`` (scale, bias)."""
    from .models.llama import LayerNorm

    module = LayerNorm(hidden, eps, device="meta")
    return lambda tree, x: torch.func.functional_call(module, tree, (x,))


def _learned_positions(table: torch.Tensor, pos: int, seq: int, offset: int, what: str):
    """Rows ``offset + pos .. offset + pos + seq`` of a learned position
    table, checked against its end first (``models.llama``)."""
    from .models.llama import _check_learned_positions

    _check_learned_positions(pos, seq, table.shape[0] - offset, what)
    return table[offset + pos:offset + pos + seq][None]


def _tied_logits(x, embedding):
    return x @ embedding.to(x.dtype).T


def _gpt2_block_specs(cfg) -> list:
    from .models.gpt2 import GPT2Block

    norm = _layer_norm(cfg.layer_norm_eps, cfg.hidden_size)

    def embed(p, ids, pos):
        return F.embedding(ids, p[0]["weight"]) + _learned_positions(p[1]["weight"], int(pos),
                                                                     ids.shape[1], 0, "GPT-2")

    def head(p, x):
        return _tied_logits(norm(p[0], x), p[1]["weight"])

    return _gptlike_block_specs(cfg, GPT2Block, "h.{i}", ("wte", "wpe"), embed,
                                ("ln_f", "wte"), head)


def _opt_block_specs(cfg) -> list:
    from .models.opt import POSITION_OFFSET, OPTBlock

    norm = _layer_norm(cfg.layer_norm_eps, cfg.hidden_size)

    def embed(p, ids, pos):
        return F.embedding(ids, p[0]["weight"]) + _learned_positions(
            p[1]["weight"], int(pos), ids.shape[1], POSITION_OFFSET, "OPT")

    def head(p, x):
        return _tied_logits(norm(p[0], x), p[1]["weight"])

    return _gptlike_block_specs(cfg, OPTBlock, "layers.{i}", ("embed_tokens", "embed_positions"),
                                embed, ("final_layer_norm", "embed_tokens"), head)


def _untied_head_specs(cfg, block_cls, layer_fmt: str, embed_name: str, norm_name: str,
                       head_name: str) -> list:
    """GPT-J, GPT-NeoX and Phi: a plain token embedding, a final norm and
    an untied head (biased where the checkpoint has a bias)."""

    norm = _layer_norm(cfg.layer_norm_eps, cfg.hidden_size)

    def embed(p, ids, pos):
        return F.embedding(ids, p[0]["weight"])

    def head(p, x):
        return F.linear(norm(p[0], x), p[1]["weight"], p[1].get("bias"))

    return _gptlike_block_specs(cfg, block_cls, layer_fmt, (embed_name,), embed,
                                (norm_name, head_name), head)


def _gptj_block_specs(cfg) -> list:
    from .models.gptj import GPTJBlock

    return _untied_head_specs(cfg, GPTJBlock, "h.{i}", "wte", "ln_f", "lm_head")


def _gpt_neox_block_specs(cfg) -> list:
    from .models.gpt_neox import GPTNeoXBlock

    return _untied_head_specs(cfg, GPTNeoXBlock, "layers.{i}", "embed_in", "final_layer_norm",
                              "embed_out")


def _phi_block_specs(cfg) -> list:
    from .models.phi import PhiBlock

    return _untied_head_specs(cfg, PhiBlock, "layers.{i}", "embed_tokens", "final_layernorm",
                              "lm_head")


def _bloom_block_specs(cfg) -> list:
    from .models.bloom import BloomBlock

    norm = _layer_norm(cfg.layer_norm_epsilon, cfg.hidden_size)

    def embed(p, ids, pos):
        return norm(p[1], F.embedding(ids, p[0]["weight"]))

    def head(p, x):
        return _tied_logits(norm(p[0], x), p[1]["weight"])

    return _gptlike_block_specs(cfg, BloomBlock, "layers.{i}",
                                ("word_embeddings", "word_embeddings_layernorm"), embed,
                                ("ln_f", "word_embeddings"), head)


def _gptlike_specs() -> tuple:
    """The GPT-style families' (model class, spec builder) pairs."""
    from .models.bloom import BloomForCausalLM
    from .models.gpt2 import GPT2LMHeadModel
    from .models.gpt_neox import GPTNeoXForCausalLM
    from .models.gptj import GPTJForCausalLM
    from .models.opt import OPTForCausalLM
    from .models.phi import PhiForCausalLM

    return ((GPT2LMHeadModel, _gpt2_block_specs), (OPTForCausalLM, _opt_block_specs),
            (GPTJForCausalLM, _gptj_block_specs), (GPTNeoXForCausalLM, _gpt_neox_block_specs),
            (PhiForCausalLM, _phi_block_specs), (BloomForCausalLM, _bloom_block_specs))


def _t5_block_specs(cfg) -> list:
    """T5's blocks (reference ``_t5_block_specs``), op for op the resident
    model's forward. The "enc" stage runs once an input and threads ``(x,
    bias, decoder_ids, mask)``; its norm hands ``(enc, decoder_ids, None,
    mask)`` to the "dec" stage, which threads ``(enc, y, bias, mask)``. Layer
    0 of each stack holds the bucket table (a kind of its own) and computes
    the bias the later layers reuse. A cached decoder block's cache holds
    the self-attention buffers ``k``/``v`` and the cross K/V ``ck``/``cv``,
    computed from ``enc`` at the prefill (``pos == 0``) and read back after.
    ``streamed(input_ids, decoder_input_ids[, attention_mask])`` gives the
    teacher-forced logits."""
    from .models.t5 import T5DecoderBlock, T5EncoderBlock, T5LayerNorm

    call = torch.func.functional_call
    norm = T5LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device="meta")
    enc_blocks = [T5EncoderBlock(cfg, has_relative_bias=first, device="meta")
                  for first in (True, False)]
    dec_blocks = [T5DecoderBlock(cfg, has_relative_bias=first, device="meta")
                  for first in (True, False)]

    def embed_enc(p, input_ids, decoder_ids, mask=None):
        return F.embedding(input_ids, p[0]["weight"]), None, decoder_ids, mask

    def enc_layer(block):
        def apply(p, x, bias, decoder_ids, mask):
            x, bias = call(block, p[0], (x, mask, bias))
            return x, bias, decoder_ids, mask

        return apply

    def enc_norm(p, x, bias, decoder_ids, mask):
        return call(norm, p[0], (x,)), decoder_ids, None, mask

    def embed_dec(p, enc, decoder_ids, bias, mask):
        return enc, F.embedding(decoder_ids, p[0]["weight"]), None, mask

    def dec_layer(block):
        def apply(p, enc, y, bias, mask):
            y, bias = call(block, p[0], (y, enc), {"cross_mask": mask, "position_bias": bias})
            return enc, y, bias, mask

        def cached(p, args, cache, pos):
            enc, y, bias, mask = args
            cross = None if pos == 0 else (cache["ck"].to(y.dtype), cache["cv"].to(y.dtype))
            y, bias, _, ckv = call(block, p[0], (y, enc), {
                "cross_mask": mask, "position_bias": bias, "cache_pos": pos, "cross_kv": cross,
                "cache": {"k": cache["k"], "v": cache["v"]}})
            if pos == 0:
                cache["ck"].copy_(ckv[0])
                cache["cv"].copy_(ckv[1])
            return (enc, y, bias, mask), cache

        return apply, cached

    def head(p, enc, y, bias, mask):
        h = call(norm, p[0], (y,))
        w = p[1]["weight"]
        if cfg.tie_word_embeddings:
            return ((h * cfg.hidden_size ** -0.5) @ w.to(h.dtype).T,)
        return (F.linear(h, w),)

    specs = [BlockSpec("embed_enc", ("shared_embedding",), embed_enc, kind="t5_embed_enc",
                       stage="enc")]
    for i in range(cfg.num_layers):
        specs.append(BlockSpec(f"encoder_layer.{i}", (f"encoder_layer.{i}",),
                               enc_layer(enc_blocks[min(i, 1)]),
                               kind="t5_enc_layer0" if i == 0 else "t5_enc_layer", stage="enc"))
    specs.append(BlockSpec("encoder_norm", ("encoder_norm",), enc_norm, kind="t5_enc_norm",
                           stage="enc"))
    specs.append(BlockSpec("embed_dec", ("shared_embedding",), embed_dec, kind="t5_embed_dec",
                           stage="dec", cached_apply=lambda p, args, cache, pos:
                           (embed_dec(p, *args), None)))
    for i in range(cfg.num_layers):
        apply, cached = dec_layer(dec_blocks[min(i, 1)])
        specs.append(BlockSpec(f"decoder_layer.{i}", (f"decoder_layer.{i}",), apply,
                               kind="t5_dec_layer0" if i == 0 else "t5_dec_layer", stage="dec",
                               cached_apply=cached, cache_slot=True))
    head_prefixes = ("decoder_norm", "shared_embedding" if cfg.tie_word_embeddings
                     else "lm_head")
    specs.append(BlockSpec("head", head_prefixes, head, kind="t5_head", stage="dec",
                           cached_apply=lambda p, args, cache, pos: (head(p, *args), None)))
    return specs


def _t5_cache_factory(cfg, device) -> Callable:
    """``(batch, max_len, dtype=bf16, src_len) -> per-decoder-layer caches``:
    the self-attention buffers ``k``/``v`` [B, max_len, H, D] and the cross
    K/V ``ck``/``cv`` [B, src_len, H, D]."""

    def factory(batch, max_len, dtype=torch.bfloat16, src_len=None):
        if src_len is None:
            raise ValueError("T5 decode caches need src_len (cross K/V width)")
        widths = {"k": max_len, "v": max_len, "ck": src_len, "cv": src_len}
        return [{name: torch.zeros((batch, n, cfg.num_heads, cfg.head_dim), dtype=dtype,
                                   device=device) for name, n in widths.items()}
                for _ in range(cfg.num_layers)]

    return factory


def _llama_cache_factory(cfg, device) -> Callable:
    from .models.llama import init_kv_cache

    def factory(batch, max_len, dtype=torch.bfloat16, ring_slack=0):
        return init_kv_cache(cfg, batch, max_len, dtype, ring_slack=ring_slack, device=device)

    return factory


def cache_factory_for(module) -> Optional[Callable]:
    """``(batch, max_len, dtype=bf16, ring_slack=0) -> per-layer KV cache``
    on the device the model computes on, for model families with cache
    threading (a streamed model's included); None otherwise. T5's factory
    takes the source length too (``src_len``: the cross K/V's width)."""
    if isinstance(module, StreamedModel):
        return module.cache_factory
    return _family_cache_factory(module)


def _family_cache_factory(module, device=None) -> Optional[Callable]:
    """The cache factory of ``module``'s family on ``device`` (default: the
    device of its parameters), or None."""
    from .models.t5 import T5ForConditionalGeneration

    if isinstance(module, T5ForConditionalGeneration):
        build = _t5_cache_factory
    elif _threads_llama_cache(module):
        build = _llama_cache_factory
    else:
        return None
    return build(module.config, next(module.parameters()).device if device is None else device)


def _threads_llama_cache(module) -> bool:
    """A model whose layers attend through ``models/llama.py``'s KV cache
    (``init_kv_cache``, ``update_kv_cache_and_attend``): the Llama family,
    Mixtral and the GPT-style families, whose configs duck-type the
    cache's fields."""
    from .models.llama import LlamaForCausalLM
    from .models.mixtral import MixtralForCausalLM

    families = (LlamaForCausalLM, MixtralForCausalLM, *(cls for cls, _ in _gptlike_specs()))
    return isinstance(module, families)


# ---------------------------------------------------------------------------
# Streamed executor
# ---------------------------------------------------------------------------

class StreamedModel:
    """Runs a block-split model whose weights live on the card, in host
    memory or on disk, double-buffering their copies to the card (see the
    module docstring). ``model(ids)`` gives the logits; ``model(ids,
    cache=..., cache_pos=...)`` the cached form ``(logits, cache)`` that
    ``generation.py``'s decoders call, as they call a resident model.
    ``prefetch=False`` fetches each block only when it runs, after the
    previous one has finished (no overlap). ``position_bound`` is the
    model's position table (``max_position_embeddings``; None for ALiBi):
    ``generate`` refuses a decode that would run past it, and a
    learned-position embedding block checks its rows before the lookup."""

    def __init__(self, specs: list, store: WeightStore, execution_device=None,
                 prefetch: bool = True, cache_factory: Optional[Callable] = None, config=None,
                 position_bound: Optional[int] = None):
        self.specs = specs
        self.store = store
        self.device = resolve_device(execution_device)
        self.prefetch = prefetch
        self.cache_factory = cache_factory
        self.config = config
        self.position_bound = position_bound
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._resident_cache: dict = {}
        self._lock = threading.Lock()
        self._names = {p: store.names_under(p) for s in specs for p in s.prefixes}

    def close(self):
        """Stop the fetch worker and drop every weight this model holds, so
        its card memory goes back to the allocator."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._resident_cache.clear()
        self.store = WeightStore()

    def __del__(self):  # best effort; close() is the API
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False)

    @property
    def hbm_resident_bytes(self) -> int:
        """Bytes of weights kept on the card for good."""
        return self.store.total_bytes("device")

    # -- weight movement ---------------------------------------------------
    def _fetch(self, spec: BlockSpec, after=None):
        """The block's weights on the execution device and the event after
        their copies (None when nothing was copied). Disk entries are read
        into pinned staging first; then, once ``after`` (the compute of the
        block before last) has finished, the copies are queued on the copy
        stream."""
        cached = self._resident_cache.get(spec.name)
        if cached is not None:
            return cached, None
        staged, resident = [], True
        for i, prefix in enumerate(spec.prefixes):
            for name in self._names[prefix]:
                val, cast = self.store.entries[name], None
                resident &= self.store.placement[name] not in ("cpu", "disk")
                if isinstance(val, (LazyWeight, LazyStack)):
                    val, cast = val.load(pin=self._cuda), val.dtype
                elif self._cuda and val.device.type == "cpu" and not val.is_pinned():
                    raise RuntimeError(
                        f"{name} is in host memory that is not pinned: its copy to the card "
                        "would be synchronous (load it through the port's loaders, which pin)")
                staged.append((i, name[len(prefix) + 1:], val, cast))
        if after is not None:
            after.synchronize()
        ptrees = tuple({} for _ in spec.prefixes)
        copying = (torch.cuda.stream(self._copy_stream) if self._cuda
                   else contextlib.nullcontext())
        with torch.inference_mode(), copying:
            for i, rel, val, cast in staged:
                val = val.to(self.device, non_blocking=True)
                ptrees[i][rel] = val if cast is None else val.to(cast)
            ready = None
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        if resident:
            with self._lock:
                self._resident_cache[spec.name] = ptrees
        return ptrees, ready

    def _fetch_on_worker(self, spec, after):
        with torch.cuda.device(self.device) if self._cuda else contextlib.nullcontext():
            return self._fetch(spec, after)

    def _run(self, step: Callable, specs: Optional[list] = None):
        """``step(spec, ptrees)`` for every block of ``specs`` (default: all)
        in order, the next block's weights fetched on the worker while the
        current one computes (a block kept on the card needs no fetch and no
        worker)."""
        specs, prefetch = specs or self.specs, self.prefetch
        if prefetch and self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="weight-prefetch")

        def start(spec, after):
            if not prefetch or spec.name in self._resident_cache:
                return None
            return self._pool.submit(self._fetch_on_worker, spec, after)

        pending = start(specs[0], None)
        done = None  # the event after the previous block's compute
        for i, spec in enumerate(specs):
            ptrees, ready = pending.result() if pending is not None else self._fetch(spec, done)
            pending = start(specs[i + 1], done) if i + 1 < len(specs) else None
            if ready is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ready)
                for tree in ptrees:
                    for t in tree.values():
                        # Allocated on the copy stream and read on this one:
                        # the allocator must not reuse it before this reads.
                        t.record_stream(compute)
            step(spec, ptrees)
            del ptrees
            if self._cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))

    # -- forward -----------------------------------------------------------
    @torch.inference_mode()
    def __call__(self, input_ids, *inputs, cache=None, cache_pos=None):
        """Logits of ``input_ids`` [B, S] through every block (an
        encoder-decoder model takes ``(input_ids, decoder_input_ids[,
        attention_mask])``); with ``cache`` (a per-layer KV cache,
        ``cache_factory``), the cached pass at ``cache_pos``, returning
        ``(logits, cache)``."""
        ids = torch.as_tensor(input_ids, device=self.device)
        if cache is not None:
            return self._cached_pass((ids,), cache, cache_pos), cache
        return self._forward((ids, *(None if t is None else torch.as_tensor(t, device=self.device)
                                     for t in inputs)))[0]

    def _forward(self, args: tuple, specs: Optional[list] = None) -> tuple:
        """``args`` through every block of ``specs`` (default: all)
        uncached; the last block's outputs (the logits first)."""
        def step(spec, ptrees):
            nonlocal args
            args = spec.apply(ptrees, *args)

        self._run(step, specs)
        return args

    def _cached_pass(self, args: tuple, caches: list, pos, specs: Optional[list] = None):
        """One pass (prefill, a decode step or a verification chunk) of
        ``args`` through every block of ``specs`` (default: all), updating
        the layers' caches in place; the logits."""
        layer = 0

        def step(spec, ptrees):
            nonlocal args, layer
            if spec.cache_slot:
                args, caches[layer] = spec.cached_apply(ptrees, args, caches[layer], pos)
                layer += 1
            else:
                args, _ = spec.cached_apply(ptrees, args, None, pos)

        self._run(step, specs)
        return args[0]

    # -- generation --------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: int = 20, eos_token_id: Optional[int] = None,
                 use_cache: bool = True, prompt_lookup_num_tokens: Optional[int] = None,
                 lookup_ngram: int = 2, assistant_model=None, num_draft: int = 5,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, cache_dtype=None):
        """Streamed decoding: greedy by default, sampled with
        ``do_sample=True`` (temperature / top-k / top-p from a
        ``torch.Generator``), through ``generation.py``'s decoders, so every
        weight streams once per pass.

        With the KV cache, one prefill pass writes the prompt's keys and
        values and each token is one pass of single-query attention.
        ``prompt_lookup_num_tokens=K`` verifies K prompt-lookup drafts a pass
        (``generation.prompt_lookup_generate``), ``assistant_model`` (a
        resident model) drafts ``num_draft`` tokens a round
        (``generation.assisted_generate``): the streamed weights then move
        once per accepted run, not once per token, and greedy output is
        plain greedy's exactly. ``use_cache=False`` runs the whole sequence
        again for each token. Returns [B, S + max_new_tokens] ids; after
        ``eos_token_id`` a row keeps emitting it."""
        from . import generation

        if any(s.stage == "enc" for s in self.specs):
            raise TypeError("this is an encoder-decoder model; use seq2seq_generate")
        ids = torch.as_tensor(input_ids, device=self.device)
        if max_new_tokens <= 0:
            return ids
        # The highest position a verification chunk touches is S +
        # max_new_tokens + K - 2: a slack of K - 1 (reference :1094-1106).
        spec_k = int(prompt_lookup_num_tokens or 0) or (
            int(num_draft) if assistant_model is not None else 0)
        slack = spec_k - 1 if spec_k else 0
        total = ids.shape[1] + max_new_tokens + slack
        if self.position_bound is not None and total > self.position_bound:
            label = ("prompt + max_new_tokens + speculative slack" if slack
                     else "prompt + max_new_tokens")
            raise ValueError(f"{label} = {total} exceeds the model's position table "
                             f"({self.position_bound}); max_position_embeddings bounds "
                             "its positions")
        if assistant_model is not None and prompt_lookup_num_tokens:
            raise ValueError("assistant_model and prompt_lookup_num_tokens are mutually "
                             "exclusive drafters")
        cached = (use_cache and self.cache_factory is not None
                  and all(s.cached_apply is not None for s in self.specs))
        if (prompt_lookup_num_tokens or assistant_model is not None) and not cached:
            raise ValueError("speculative decoding needs the KV cache (cached_apply on every "
                             "block spec, a cache_factory) and use_cache=True")
        sampling = dict(do_sample=do_sample, temperature=temperature, top_k=top_k,
                        top_p=top_p, generator=generator)
        if assistant_model is not None:
            return generation.assisted_generate(
                self, assistant_model, ids, max_new_tokens, num_draft=num_draft,
                eos_token_id=eos_token_id, cache_dtype=cache_dtype, **sampling)
        if prompt_lookup_num_tokens:
            return generation.prompt_lookup_generate(
                self, ids, max_new_tokens, eos_token_id=eos_token_id, cache_dtype=cache_dtype,
                ngram=lookup_ngram, num_draft=prompt_lookup_num_tokens, **sampling)
        if cached:
            return generation.generate(self, ids, max_new_tokens, eos_token_id=eos_token_id,
                                       cache_dtype=cache_dtype, **sampling)
        select = generation._make_selector((float(temperature), top_k, top_p)
                                           if do_sample else None)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        seen = torch.zeros((ids.shape[0], 1), dtype=torch.bool, device=self.device)
        done = torch.zeros(ids.shape[0], dtype=torch.bool, device=self.device)
        for _ in range(max_new_tokens):
            nxt, done = generation._next_token(self(ids)[:, -1], generator, seen, done, select,
                                               eos_token_id, ids.dtype)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
        return ids

    @torch.inference_mode()
    def seq2seq_generate(self, input_ids, max_new_tokens: int = 20,
                         decoder_start_token_id: int = 0, eos_token_id: Optional[int] = None,
                         use_cache: bool = True, cache_dtype=None, attention_mask=None):
        """Greedy encoder-decoder decoding with streamed weights (T0pp-class
        models). The source is padded and masked as
        ``generation.seq2seq_generate`` pads it, and the encoder blocks run
        once; each step runs only the "dec" stage. With the cache, one
        prefill of the start token writes the self-attention buffers and
        each layer's cross K/V, and each later token is one pass of
        single-query attention; ``use_cache=False`` runs the whole decoder
        sequence again for each token. After ``eos_token_id`` a row keeps
        emitting it, and the loop stops once every row has.

        Returns [B, 1 + generated] decoder ids, the start token first."""
        from .generation import _make_selector, _next_token, _padded_source

        enc_specs = [s for s in self.specs if s.stage == "enc"]
        dec_specs = [s for s in self.specs if s.stage == "dec"]
        if not enc_specs or not dec_specs:
            raise TypeError("seq2seq_generate needs enc/dec-staged block specs")
        ids = torch.as_tensor(input_ids, device=self.device)
        B = ids.shape[0]
        start = torch.full((B, 1), decoder_start_token_id, dtype=ids.dtype, device=self.device)
        if max_new_tokens <= 0:
            return start
        ids, mask = _padded_source(ids, attention_mask)
        enc, _, _, mask = self._forward((ids, start, mask), enc_specs)
        cached = use_cache and all(s.cached_apply is not None for s in dec_specs)
        if cached:
            if self.cache_factory is None:
                raise TypeError("cached seq2seq decode needs a cache_factory")
            caches = self.cache_factory(B, max_new_tokens, dtype=cache_dtype or torch.bfloat16,
                                        src_len=ids.shape[1])
        select = _make_selector(None)
        seen = torch.zeros((B, 1), dtype=torch.bool, device=self.device)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        dec = start
        for t in range(max_new_tokens):
            if cached:
                logits = self._cached_pass((enc, dec[:, -1:], None, mask), caches, t, dec_specs)
            else:
                logits = self._forward((enc, dec, None, mask), dec_specs)[0]
            tok, done = _next_token(logits[:, -1], None, seen, done, select, eos_token_id,
                                    ids.dtype)
            dec = torch.cat([dec, tok[:, None]], dim=1)
            if eos_token_id is not None and bool(done.all()):
                break
        return dec


# ---------------------------------------------------------------------------
# Loading and dispatch
# ---------------------------------------------------------------------------

def _placement_for(name: str, device_map: dict) -> DeviceId:
    best, best_len = None, -1
    for prefix, dev in device_map.items():
        if (prefix == "" or name == prefix or name.startswith(prefix + ".")) \
                and len(prefix) > best_len:
            best, best_len = dev, len(prefix)
    if best is None:
        raise ValueError(f"{name} not covered by device_map")
    return best


def _card(place: int, device: torch.device) -> torch.device:
    """The device an integer placement names: ``cuda:<i>``, or the
    execution device when that is not a card."""
    return torch.device("cuda", place) if device.type == "cuda" else device


def _host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    t = t.detach().to("cpu")
    return t.pin_memory() if pin else t


def load_checkpoint_in_model(model, checkpoint, device_map: Optional[dict] = None, dtype=None,
                             offload_folder: Optional[str] = None,
                             offload_to_memmap: bool = False,
                             key_map: Optional[Callable] = None,
                             execution_device=None) -> WeightStore:
    """Read a safetensors checkpoint (a file, or a directory of one file or
    of shards) tensor by tensor into a placed :class:`WeightStore`.

    Placement per tensor follows ``device_map`` (longest prefix): an int
    puts it on that card; ``"cpu"`` in host memory, pinned when the
    execution device is a card; ``"disk"`` leaves a :class:`LazyWeight`
    into the shard (no copy), or writes a memmap copy under
    ``offload_folder`` with ``offload_to_memmap=True``. Host memory holds
    one tensor at a time beyond what it keeps. ``key_map(checkpoint key)``
    gives the port's name (or None to skip), or ``(name, op)``: an HF
    checkpoint's names cross that way (``utils/hf_interop.map_hf_key`` and
    ``map_hf_key_and_op``). An op ``"t"`` transposes the tensor on read;
    ``"stack:<e>:t"`` makes it member ``e`` of a stacked leaf, gathered into
    a :class:`LazyStack` and placed as one tensor once every member is
    seen. ``model`` (the meta-device model) names the parameters expected;
    a missing one raises."""
    from .utils.hf_interop import apply_op, stack_members
    from .utils.offload import offload_weight, save_offload_index

    device = resolve_device(execution_device)
    pin = device.type == "cuda"
    device_map = device_map or {"": 0}
    store = WeightStore()
    shapes = ({n: tuple(p.shape) for n, p in named_parameters(model).items()}
              if model is not None else None)
    memmap_index: dict = {}
    stacks: dict = {}

    def place_tensor(name, t, place):
        nonlocal memmap_index
        if isinstance(place, int):
            t = t.to(_card(place, device))
        if dtype is not None:
            t = t.to(dtype)
        if place == "disk":
            memmap_index = offload_weight(t, name, offload_folder, memmap_index)
            store.put(name, LazyWeight(os.path.join(offload_folder, f"{name}.dat"), name,
                                       memmap_info=memmap_index[name]), place)
        else:
            store.put(name, _host(t, pin) if place == "cpu" else t, place)

    for shard in checkpoint_shards(checkpoint):
        for key in shard.keys():
            hit = key_map(key) if key_map is not None else key
            name, op = hit if isinstance(hit, tuple) else (hit, None)
            if name is None or (shapes is not None and name not in shapes):
                continue
            if op is not None and op.startswith("stack:"):
                stacks.setdefault(name, {})[int(op.split(":")[1])] = LazyWeight(
                    shard.path, key, dtype, source=shard, transform="t")
                continue
            place = _placement_for(name, device_map)
            if place == "disk" and not offload_to_memmap:
                store.put(name, LazyWeight(shard.path, key, dtype, source=shard, transform=op),
                          place)
                continue
            place_tensor(name, apply_op(shard.read(key), op), place)
    for name, members in stacks.items():
        count = shapes[name][0] if shapes is not None else None
        lazy = LazyStack(stack_members(name, members, count), dtype)
        place = _placement_for(name, device_map)
        if place == "disk" and not offload_to_memmap:
            store.put(name, lazy, place)
        else:
            place_tensor(name, lazy.load(), place)
    if memmap_index:
        save_offload_index(memmap_index, offload_folder)
    if shapes is not None:
        missing = set(shapes) - set(store.entries)
        if missing:
            raise ValueError(f"Checkpoint {checkpoint} is missing keys: {sorted(missing)[:5]}...")
    return store


def store_from_params(params, device_map: dict, execution_device=None) -> WeightStore:
    """Place an in-memory state dict per ``device_map`` (dispatch without a
    checkpoint). The disk tier needs a checkpoint or an offload folder."""
    device = resolve_device(execution_device)
    store = WeightStore()
    for name, t in named_parameters(params).items():
        place = _placement_for(name, device_map)
        if place == "disk":
            raise ValueError("store_from_params cannot disk-offload; use "
                             "load_checkpoint_in_model or disk_offload")
        store.put(name, _host(t, device.type == "cuda") if place == "cpu"
                  else t.detach().to(_card(place, device)), place)
    return store


def dispatch_model(module, params=None, store: Optional[WeightStore] = None,
                   device_map: Optional[dict] = None, block_specs: Optional[list] = None,
                   execution_device=None) -> StreamedModel:
    """Wrap a model for execution with its weights spread over card, host
    and disk. The weights come from ``store``, or from ``params`` (a state
    dict; by default the module's own) placed by ``device_map``
    (default: all on card 0). The execution device defaults to the first
    card a placement names."""
    specs = block_specs or block_specs_for(module)
    if specs is None:
        raise ValueError(f"No block specs known for {type(module).__name__}; "
                         "pass block_specs=[BlockSpec(...)]")
    if store is None:
        if params is None:
            params = module.state_dict()
            if any(t.is_meta for t in params.values()):
                raise ValueError("dispatch_model needs params or a WeightStore for a model on "
                                 "the meta device")
        store = store_from_params(params, device_map or {"": 0}, execution_device)
    if execution_device is None:
        cards = [d for d in store.placement.values() if isinstance(d, int)]
        execution_device = f"cuda:{cards[0] if cards else 0}"
    device = resolve_device(execution_device)
    config = getattr(module, "config", None)
    return StreamedModel(specs, store, device, cache_factory=_family_cache_factory(module, device),
                         config=config, position_bound=getattr(config, "max_position_embeddings",
                                                               None))


def load_checkpoint_and_dispatch(module, checkpoint, device_map: Union[str, dict, None] = "auto",
                                 max_memory: Optional[dict] = None,
                                 no_split_module_classes: Optional[list] = None, dtype=None,
                                 offload_folder: Optional[str] = None,
                                 offload_to_memmap: bool = False,
                                 block_specs: Optional[list] = None,
                                 key_map: Optional[Callable] = None,
                                 execution_device=None) -> StreamedModel:
    """One call: device-map solve (``"auto"``, ``"balanced"``) over the
    meta-device ``module``, shard-streamed load, streaming executor."""
    device = resolve_device(execution_device)
    if device_map in ("auto", "balanced", None):
        mm = (get_balanced_memory(module, max_memory=max_memory,
                                  no_split_module_classes=no_split_module_classes, dtype=dtype)
              if device_map == "balanced" else max_memory)
        device_map = infer_auto_device_map(module, max_memory=mm, dtype=dtype,
                                           no_split_module_classes=no_split_module_classes)
    check_device_map(module, device_map)
    store = load_checkpoint_in_model(module, checkpoint, device_map=device_map, dtype=dtype,
                                     offload_folder=offload_folder,
                                     offload_to_memmap=offload_to_memmap, key_map=key_map,
                                     execution_device=device)
    return dispatch_model(module, store=store, block_specs=block_specs, execution_device=device)


#: The HF families :func:`load_hf_checkpoint_and_dispatch` streams (the
#: reference's list).
_STREAMABLE_FAMILIES = ("llama", "mistral", "qwen2", "qwen2_moe", "gemma", "gemma2", "gpt2",
                       "gptj", "gpt_neox", "bloom", "opt", "phi", "t5", "mixtral")


def load_hf_checkpoint_and_dispatch(checkpoint_dir: str,
                                    device_map: Union[str, dict, None] = "auto",
                                    max_memory: Optional[dict] = None, dtype=None,
                                    offload_folder: Optional[str] = None,
                                    offload_to_memmap: bool = False, config=None,
                                    execution_device=None):
    """Big-model load straight from a HuggingFace checkpoint directory of the
    Llama, Mixtral and GPT-style families and T5 (``utils/hf_interop.py``;
    T5 generates through ``streamed.seq2seq_generate``): the names are
    translated tensor by tensor as the shards stream, so weights go from
    disk to their placement with no full state dict in between, and
    disk-tier weights keep lazy references into the HF shards (a Mixtral
    layer's experts as a :class:`LazyStack`). ``dtype`` casts the weights
    (and sizes the device map). Returns ``(streamed_model, module)``, the
    module on the meta device."""
    from .utils.hf_interop import map_hf_key_and_op, open_hf_checkpoint

    family, config, module = open_hf_checkpoint(checkpoint_dir, config, dtype)
    if family not in _STREAMABLE_FAMILIES:
        raise ValueError(f"streamed dispatch supports {'/'.join(_STREAMABLE_FAMILIES)} (got "
                         f"{family!r}); use utils.load_hf_checkpoint + dispatch_model for other "
                         "families")
    streamed = load_checkpoint_and_dispatch(
        module, checkpoint_dir, device_map=device_map, max_memory=max_memory, dtype=dtype,
        offload_folder=offload_folder, offload_to_memmap=offload_to_memmap,
        key_map=lambda key: map_hf_key_and_op(key, family), execution_device=execution_device)
    return streamed, module


def cpu_offload(module, params=None, execution_device=None,
                block_specs: Optional[list] = None) -> StreamedModel:
    """All weights in pinned host memory, streamed block by block onto the
    card."""
    return dispatch_model(module, params=params, device_map={"": "cpu"}, block_specs=block_specs,
                          execution_device=execution_device)


class UserCpuOffloadHook:
    """The handle :func:`cpu_offload_with_hook` returns, so a pipeline of
    models can free the card between them. Streaming keeps the weights in
    host memory between calls already; :meth:`offload` releases whatever the
    executor left on the card."""

    def __init__(self, model: StreamedModel):
        self.model = model

    def offload(self):
        """Release the model's card-resident buffers (host copies stay)."""
        # The worker first: a fetch finishing after the clear would fill
        # the cache again.
        if self.model._pool is not None:
            self.model._pool.shutdown(wait=True, cancel_futures=True)
            self.model._pool = None
        self.model._resident_cache.clear()

    def remove(self):
        """The reference's name for :meth:`offload`."""
        self.offload()


def cpu_offload_with_hook(module, params=None, execution_device=None,
                          block_specs: Optional[list] = None,
                          prev_module_hook: Optional[UserCpuOffloadHook] = None):
    """``(streamed_model, hook)``: run several models on one card and call
    ``hook.offload()`` between them. ``prev_module_hook`` (the previous
    stage's) is offloaded now."""
    if prev_module_hook is not None:
        prev_module_hook.offload()
    streamed = cpu_offload(module, params, execution_device=execution_device,
                           block_specs=block_specs)
    return streamed, UserCpuOffloadHook(streamed)


def disk_offload(module, checkpoint, offload_folder: Optional[str] = None,
                 execution_device=None, block_specs: Optional[list] = None) -> StreamedModel:
    """All weights on disk, streamed block by block. Without
    ``offload_folder`` the store keeps lazy references into the
    checkpoint's shards; with one, it writes memmap copies there first."""
    device = resolve_device(execution_device)
    store = load_checkpoint_in_model(module, checkpoint, device_map={"": "disk"},
                                     offload_folder=offload_folder,
                                     offload_to_memmap=offload_folder is not None,
                                     execution_device=device)
    return dispatch_model(module, store=store, block_specs=block_specs, execution_device=device)
