"""Plain reference of a dense decoder's forward (Mistral-7B, Jiang et al.
2023, arXiv:2310.06825, and the published ``MistralForCausalLM``):
RMSNorm, rotary embedding at ``theta``, grouped-query causal attention
within a sliding window, a SwiGLU MLP and an untied head, in float32 with
TF32 off. Imports nothing of the program.

It runs layer by layer over every sequence it is given, so that one
layer's weights in float32 are what is held beside the hidden states: the
caller hands it a function that makes layer ``i``'s weights (from their
seed, in the dtype they are served in), and they are widened to float32
here. Departures from the published description: none (the rotary tables
are computed in float32; the published code computes them in the model's
dtype).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .common import causal_attention, exact_f32, rms_norm, rotary


def _layer(x, w, i, cfg, positions):
    """One decoder layer of one sequence ``x`` [S, D] (float32)."""
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    h = rms_norm(x, w[f"L{i}.attn_norm"], cfg["rms_norm_eps"])
    q = (h @ w[f"L{i}.wq"].T).view(-1, H, hd)
    k = (h @ w[f"L{i}.wk"].T).view(-1, G, hd)
    v = (h @ w[f"L{i}.wv"].T).view(-1, G, hd)
    q, k = rotary(q, positions, cfg["rope_theta"]), rotary(k, positions, cfg["rope_theta"])
    x = x + causal_attention(q, k, v, cfg.get("sliding_window")) @ w[f"L{i}.wo"].T
    h = rms_norm(x, w[f"L{i}.mlp_norm"], cfg["rms_norm_eps"])
    return x + (F.silu(h @ w[f"L{i}.w_gate"].T) * (h @ w[f"L{i}.w_up"].T)) @ w[f"L{i}.w_down"].T


@torch.no_grad()
def logits_at(cfg: dict, ends: dict, layer: Callable[[int], dict], sequences: list,
              picks: list) -> list:
    """Float32 logits of each sequence (token ids, a 1-d tensor) at the
    positions ``picks[j]`` (a 1-d index tensor into sequence ``j``).
    ``ends`` holds ``embed``, ``final_norm`` and ``head``; ``layer(i)``
    makes layer ``i``'s weights."""
    exact_f32()
    xs = [ends["embed"][s].float() for s in sequences]
    for i in range(cfg["num_hidden_layers"]):
        w = {k: t.float() for k, t in layer(i).items()}
        xs = [_layer(x, w, i, cfg, torch.arange(x.shape[0], device=x.device)) for x in xs]
        del w
    norm, head = ends["final_norm"].float(), ends["head"].float()
    return [rms_norm(x[p], norm, cfg["rms_norm_eps"]) @ head.T for x, p in zip(xs, picks)]
