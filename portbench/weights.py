"""Seeded random weights, made on the device in a few large calls.

The benchmark makes the weights and hands the same tensors to the program
and, regenerated from the same seed, to the plain reference. Each group
(the embedding, each decoder layer, the head) is one ``torch.randn`` call
on its own generator, seeded from ``(seed, group)``, in the dtype the
weights are held in, cut into the group's matrices and scaled to
``N(0, 1 / fan_in)``. Norm scales are 1. So one layer's weights can be made
again alone, which lets the reference run layer by layer.

Names are the benchmark's own (``embed``, ``L<i>.wq``, ...), matrices
``[out, in]`` except the router ``[D, E]`` and the stacked experts
``[E, in, out]``; the traffic modules map them onto the program's names.
"""

from __future__ import annotations

import numpy as np
import torch


def _dims(cfg: dict) -> dict:
    D, H, G = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    return dict(D=D, F=cfg["intermediate_size"], V=cfg["vocab_size"], H=H, G=G, hd=hd,
                E=cfg.get("num_local_experts"))


def layer_shapes(cfg: dict) -> list:
    """``(suffix, shape, fan_in)`` of one decoder layer's matrices."""
    d = _dims(cfg)
    D, F, H, G, hd, E = d["D"], d["F"], d["H"], d["G"], d["hd"], d["E"]
    out = [("wq", (H * hd, D), D), ("wk", (G * hd, D), D), ("wv", (G * hd, D), D),
           ("wo", (D, H * hd), H * hd)]
    if E:
        out += [("router", (D, E), D), ("e_gate", (E, D, F), D), ("e_up", (E, D, F), D),
                ("e_down", (E, F, D), F)]
    else:
        out += [("w_gate", (F, D), D), ("w_up", (F, D), D), ("w_down", (D, F), F)]
    return out


def _generator(seed: int, group: int, device) -> torch.Generator:
    word = np.random.SeedSequence([int(seed) % 2**64, group]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def _group(shapes, seed: int, group: int, device, dtype) -> dict:
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    flat = torch.randn(total, generator=_generator(seed, group, device), device=device,
                       dtype=dtype)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].view(shape).mul_(fan_in ** -0.5)
        at += n
    return out


def make_layer(cfg: dict, seed: int, i: int, device, dtype) -> dict:
    """Decoder layer ``i``'s weights, named ``L<i>.<suffix>``, with its two
    norm scales. The matrices are views into one buffer."""
    D = cfg["hidden_size"]
    w = {f"L{i}.{k}": v for k, v in _group(layer_shapes(cfg), seed, 1 + i, device, dtype).items()}
    w[f"L{i}.attn_norm"] = torch.ones(D, device=device, dtype=dtype)
    w[f"L{i}.mlp_norm"] = torch.ones(D, device=device, dtype=dtype)
    return w


def make_ends(cfg: dict, seed: int, device, dtype) -> dict:
    """The embedding, the final norm's scale and the head."""
    d = _dims(cfg)
    L = cfg["num_hidden_layers"]
    w = _group([("embed", (d["V"], d["D"]), d["D"])], seed, 0, device, dtype)
    w.update(_group([("head", (d["V"], d["D"]), d["D"])], seed, 1 + L, device, dtype))
    w["final_norm"] = torch.ones(d["D"], device=device, dtype=dtype)
    return w


def make_all(cfg: dict, seed: int, device, dtype) -> dict:
    """Every weight of the model."""
    w = make_ends(cfg, seed, device, dtype)
    for i in range(cfg["num_hidden_layers"]):
        w.update(make_layer(cfg, seed, i, device, dtype))
    return w
