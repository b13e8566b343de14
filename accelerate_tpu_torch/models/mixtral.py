"""Mixtral-family sparse-MoE decoder in PyTorch (and Qwen2-MoE's options).

Counterpart of ``accelerate_tpu/models/mixtral.py``: the Llama backbone
(``RMSNorm``, rotary, GQA attention from ``models/llama.py``) with the MLP
replaced by the sparse expert layer of ``ops/moe.py``. Module and parameter
names mirror the flax tree, which has no ``model`` scope
(``embed_tokens``, ``layers.<i>.self_attn.q_proj``, ``layers.<i>.mlp.router``,
``layers.<i>.mlp.experts.gate_proj``, ``norm``, ``lm_head``), so
``utils/convert.py`` moves weights across by name.

* The experts keep the JAX stack layout: ``gate_proj``/``up_proj``
  ``[E, D, F]`` and ``down_proj`` ``[E, F, D]``, plain parameters (no
  ``nn.Linear``), so ``x @ W`` is a batched matmul and the ep/fsdp specs of
  ``parallel/sharding.py`` are the reference's string for string. The
  router is ``[D, E]``, as in the reference. (HF stores each expert's
  ``Linear.weight`` ``[out, in]``: its weights are transposed on the way in,
  ``utils/hf_interop.py``.)
* A block returns ``(x, aux)`` (``(x, aux, cache)`` with a cache); the
  model returns ``(logits, {"load_balance_loss", "router_z_loss"})``, each
  averaged over the layers, or with a cache ``(logits, cache)``, routing
  with no drops (``no_drop``: capacity factor E), which is the contract
  ``generate`` expects.
* The layer loop takes each layer's parameters from a sharded layout's
  gather (``parallel/sharding.py``), as the Llama loops do, and under remat
  checkpoints the whole block (``cfg.remat`` / the FSDP plugin's
  activation checkpointing), whose output carries the router losses.
* Router jitter (``router_noise_eps > 0``) draws one int64 key a layer from
  the generator the loss passes, before the layer runs, and the layer's
  noise is a hash of its key (``ops/moe.py``), so a recomputed layer draws
  the same noise. It cannot match JAX's threefry draws.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.moe import moe_mlp_apply
from ..parallel.sharding import RematPolicy, _SumGradient, resolve_remat_policy
from ..utils.device import resolve_device
from .llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaMLP,
    RMSNorm,
    _default_positions,
    _cp_start,
    _KeptProducts,
    _layout_of,
    _lm_head,
    _loss_inputs,
    _masked_ce,
    _module,
    _ReduceFromTP,
    _remat_of,
    _split_group,
    init_weights,
)


@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.02
    router_z_coef: float = 0.001
    # Multiplicative jitter on the router logits in training (Switch §2.2),
    # on when the loss is given a generator.
    router_noise_eps: float = 0.0
    # None: one routing group per data shard (ops/moe.py default_num_groups).
    num_expert_groups: Optional[int] = None
    # Qwen2-MoE: renormalise the top-k gates (None: iff top_k > 1); an
    # always-on SwiGLU expert added under a per-token sigmoid gate; layers
    # with a plain dense MLP of dense_intermediate_size.
    norm_topk_prob: Optional[bool] = None
    shared_expert_intermediate_size: Optional[int] = None
    mlp_only_layers: tuple = ()
    dense_intermediate_size: Optional[int] = None

    @classmethod
    def mixtral_8x7b(cls, **overrides):
        cfg = cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=32768, rope_theta=1e6,
            num_experts=8, top_k=2,
        )
        return dataclasses.replace(cfg, **overrides)

    @classmethod
    def tiny_moe(cls, **overrides):
        cfg = cls(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_experts=4, top_k=2,
            num_expert_groups=1,
        )
        return dataclasses.replace(cfg, **overrides)


class MixtralSparseMLP(nn.Module):
    """Router and stacked SwiGLU experts, dispatched by ``ops/moe.py``.

    ``no_drop=True`` sizes the capacity so that no token drops (factor E):
    the decode setting, since capacity dropping is a training trade and a
    cached pass routes other token counts than a full forward; a forward's
    ``no_drop`` overrides it (the block passes True with a cache). The last
    forward's routing counters (``expert_load`` [E], ``dropped_fraction``)
    and router losses stay on the module as detached device tensors
    (``last_routing``)."""

    def __init__(self, config: MixtralConfig, no_drop: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.no_drop = no_drop
        D, F_, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        self.router = nn.Parameter(torch.empty(D, E, device=device, dtype=dtype))
        self.experts = nn.Module()
        self.experts.gate_proj = nn.Parameter(torch.empty(E, D, F_, device=device, dtype=dtype))
        self.experts.up_proj = nn.Parameter(torch.empty(E, D, F_, device=device, dtype=dtype))
        self.experts.down_proj = nn.Parameter(torch.empty(E, F_, D, device=device, dtype=dtype))
        if cfg.shared_expert_intermediate_size:
            Fs = cfg.shared_expert_intermediate_size

            def linear(i, o):
                return nn.Linear(i, o, bias=False, device=device, dtype=dtype)

            self.shared_gate_proj = linear(D, Fs)
            self.shared_up_proj = linear(D, Fs)
            self.shared_down_proj = linear(Fs, D)
            self.shared_expert_gate = linear(D, 1)
        self.last_routing: dict = {}

    def forward(self, x, no_drop: Optional[bool] = None, router_noise=None):
        cfg = self.config
        no_drop = self.no_drop if no_drop is None else no_drop
        capacity_factor = float(cfg.num_experts) if no_drop else cfg.capacity_factor
        experts = {"gate_proj": self.experts.gate_proj, "up_proj": self.experts.up_proj,
                   "down_proj": self.experts.down_proj}
        out, aux = moe_mlp_apply(
            experts, self.router, x, top_k=cfg.top_k, capacity_factor=capacity_factor,
            num_groups=cfg.num_expert_groups, router_noise_rng=router_noise,
            router_noise_eps=cfg.router_noise_eps, normalize_gates=cfg.norm_topk_prob,
            intermediate_size=cfg.intermediate_size)
        self.last_routing = {k: aux.pop(k) for k in ("expert_load", "dropped_fraction")}
        self.last_routing.update({k: aux[k].detach() for k in ("load_balance_loss",
                                                                 "router_z_loss")})
        if cfg.shared_expert_intermediate_size:
            # Column/row parallel over tp when the layout split it.
            tp = _split_group(self.shared_gate_proj.weight.shape[0],
                              cfg.shared_expert_intermediate_size, "the shared expert")
            xs = x if tp is None else _SumGradient.apply(x, tp)
            shared = self.shared_down_proj(F.silu(self.shared_gate_proj(xs))
                                           * self.shared_up_proj(xs))
            if tp is not None:
                shared = _ReduceFromTP.apply(shared, tp)
            gate = torch.sigmoid(self.shared_expert_gate(x).float()).to(out.dtype)
            out = out + gate * shared
        return out, aux


def _zero_losses(x) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return {"load_balance_loss": zero, "router_z_loss": zero}


class MixtralBlock(nn.Module):
    def __init__(self, config: MixtralConfig, layer_idx: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dense = layer_idx in cfg.mlp_only_layers

        def norm():
            return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)

        self.input_norm = norm()
        self.self_attn = LlamaAttention(cfg, window=cfg.window_for(layer_idx), device=device,
                                        dtype=dtype)
        self.post_attn_norm = norm()
        if self.dense:
            # Qwen2-MoE mlp_only_layers: a plain SwiGLU, zero router losses.
            dense = dataclasses.replace(
                cfg, intermediate_size=cfg.dense_intermediate_size or cfg.intermediate_size)
            self.mlp = LlamaMLP(dense, device=device, dtype=dtype)
        else:
            self.mlp = MixtralSparseMLP(cfg, device=device, dtype=dtype)

    def forward(self, x, positions, cache=None, cache_pos=None, router_noise=None):
        attn = self.self_attn(self.input_norm(x), positions, cache=cache, cache_pos=cache_pos)
        if cache is not None:
            attn, cache = attn
        h = x + attn
        normed = self.post_attn_norm(h)
        if self.dense:
            out, aux = self.mlp(normed), _zero_losses(x)
        else:
            out, aux = self.mlp(normed, no_drop=cache is not None, router_noise=router_noise)
        out = h + out
        return (out, aux) if cache is None else (out, aux, cache)


def _run_block(block, params, x, positions, router_noise, gather):
    """One block through ``functional_call`` on ``params``, put together
    first by ``gather`` (a sharded layout's, or None)."""
    if gather is not None:
        params = gather(params)
    return torch.func.functional_call(block, params, (x, positions),
                                      {"router_noise": router_noise})


def _remat_block(block, params, x, positions, router_noise, policy, gather,
                 gather_inside: bool):
    """One block under ``torch.utils.checkpoint`` (non-reentrant), by
    ``policy`` as ``models/llama.py``'s ``_remat_layer``: "dots" keeps the
    attention projections' outputs (the experts' batched products are
    recomputed, as JAX's ``dots_with_no_batch_dims_saveable`` does), and a
    sharded layer's gather runs outside the checkpoint or, with
    ``gather_inside``, inside it."""
    if gather is not None and not gather_inside:
        params, gather = gather(params), None
    rule = resolve_remat_policy(policy)
    if rule is RematPolicy.EVERYTHING:
        return _run_block(block, params, x, positions, router_noise, gather)
    if rule is RematPolicy.NOTHING:
        return checkpoint(_run_block, block, params, x, positions, router_noise, gather,
                          use_reentrant=False)
    kept = _KeptProducts()
    out = checkpoint(kept.run, _run_block, block, params, x, positions, router_noise, gather,
                     use_reentrant=False)
    kept.recomputing = True
    return out


@torch.no_grad()
def init_mixtral_weights(module: nn.Module, generator: torch.Generator):
    """Random weights from ``generator``: the Llama rule
    (``models/llama.py``'s ``init_weights``: N(0, 1/fan_in), biases zero,
    norm scales 1), where the fan-in of the router ``[D, E]`` and of the
    stacked experts ``[E, in, out]`` is their second-to-last dim."""
    init_weights(module, generator)
    for name, p in module.named_parameters():
        if name.endswith("mlp.router") or ".experts." in name:
            p.normal_(0.0, p.shape[-2] ** -0.5, generator=generator)


class MixtralForCausalLM(nn.Module):
    """Mixtral-family causal LM. Built on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``) in ``dtype``;
    ``generator`` draws random weights (:func:`init_mixtral_weights`),
    else load them (``load_state_dict(state_dict_from_flax(params,
    config))``)."""

    #: Where a sharded layout gathers one decoder layer at a time.
    _layer_prefixes = ("layers.",)

    def __init__(self, config: MixtralConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(MixtralBlock(cfg, layer_idx=i, device=device, dtype=dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=device,
                                     dtype=dtype)
        if generator is not None:
            init_mixtral_weights(self, generator)

    def forward(self, input_ids, positions=None, cache=None, cache_pos=None,
                router_generator: Optional[torch.Generator] = None):
        """Logits and the layer-averaged router losses; with ``cache`` (a
        per-layer KV cache, ``init_kv_cache``) ``(logits, cache)``.
        ``router_generator`` draws the router jitter (with
        ``router_noise_eps > 0``)."""
        cfg = self.config
        if positions is None:
            positions = _default_positions(
                input_ids, _cp_start(input_ids.shape[1]) if cache_pos is None else cache_pos)
        x = self.embed_tokens(input_ids)
        layout, prefix = _layout_of(self)
        policy = _remat_of(cfg, layout)
        remat = policy is not None and cache is None and torch.is_grad_enabled()
        keys = None
        if router_generator is not None and cfg.router_noise_eps > 0.0 and cache is None:
            keys = torch.randint(0, 2**62, (len(self.layers),), generator=router_generator,
                                 device=router_generator.device).to(x.device)
        lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            key = keys[i] if keys is not None else None
            gather = None if layout is None else functools.partial(
                layout.gather_layer, f"{prefix}layers.{i}.")
            if cache is not None:
                x, aux, cache[i] = layer(x, positions, cache=cache[i], cache_pos=cache_pos)
            elif remat:
                x, aux = _remat_block(layer, dict(layer.named_parameters()), x, positions, key,
                                      policy, gather, layout is not None and layout.gather_in_remat)
            elif gather is not None:
                x, aux = _run_block(layer, dict(layer.named_parameters()), x, positions, key,
                                    gather)
            else:
                x, aux = layer(x, positions, router_noise=key)
            lb = lb + aux["load_balance_loss"]
            zl = zl + aux["router_z_loss"]
        x = self.norm(x)
        logits = _lm_head(cfg, x, self.embed_tokens.weight, getattr(self, "lm_head", None))
        if cache is not None:
            # Decode: the router losses are a training quantity.
            return logits, cache
        n = cfg.num_hidden_layers
        return logits, {"load_balance_loss": lb / n, "router_z_loss": zl / n}

    def routing_counters(self) -> list:
        """Each sparse layer's last routing counters and router losses
        (``expert_load``, ``dropped_fraction``, ``load_balance_loss``,
        ``router_z_loss``), detached device tensors."""
        return [layer.mlp.last_routing for layer in self.layers if not layer.dense]


def mixtral_lm_loss(model, config: Optional[MixtralConfig] = None):
    """``loss_fn(params, batch, rng=None)``: next-token cross-entropy over
    the full logits plus the router losses, ``ce + router_aux_coef * lb +
    router_z_coef * z`` (reference ``accelerate_tpu/models/mixtral.py:
    221-241``). ``rng`` (the accelerator's generator) draws the router
    jitter when ``router_noise_eps > 0``. On a mesh whose ``cp`` axis
    splits the sequence the cross-entropy is over this process's chunk of
    each row (``models/llama.py``'s ``_loss_inputs``).

    ``loss_fn.label_count(batch)`` gives the cross-entropy's label count,
    so the accelerator weights each process's loss by its share of the
    global count, as for ``fused_causal_lm_loss``. The router losses are
    global on every process (``ops/moe.py`` sums their statistics over the
    processes and, in the backward, the incoming gradient over the data
    axes), so the weights, which add up to one, do not re-weight them: the
    reported loss is the global batch's cross-entropy plus the global
    router terms, and the summed gradients are those of that loss."""
    module = _module(model)
    cfg = config if config is not None else module.config

    def loss_fn(params, batch, rng=None):
        generator = rng if (rng is not None and cfg.router_noise_eps > 0.0) else None
        ids, kwargs, safe, mask = _loss_inputs(batch)
        positions = kwargs.get("positions")
        logits, aux = torch.func.functional_call(module, params, (ids, positions),
                                                 {"router_generator": generator})
        ce = _masked_ce(logits, safe, mask)
        return (ce + cfg.router_aux_coef * aux["load_balance_loss"]
                + cfg.router_z_coef * aux["router_z_loss"])

    loss_fn.label_count = lambda batch: _loss_inputs(batch)[3].sum()
    return loss_fn
