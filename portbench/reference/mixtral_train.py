"""Plain reference of the Mixtral training step: forward, loss, gradients,
global-norm clip and AdamW, in float32 with TF32 off. Imports nothing of
the program.

The model (Mixtral-8x7B, Jiang et al. 2024, arXiv:2401.04088, and the
published ``MixtralForCausalLM``): RMSNorm, rotary embedding at ``theta``,
grouped-query causal attention, a sparse MoE MLP of SwiGLU experts with
top-2 routing, an untied head. Departures from the published, dropless
model, all of them the configuration's stated training semantics
(``assumed`` in its file), which the program implements too:

* Capacity. Routing is over one group of all the batch's tokens; each
  expert takes ``C = ceil(2 * N * capacity_factor / E)`` (rounded up to a
  multiple of 8) pairs. Priority is every token's first choice before any
  second choice, then token order; a pair past its expert's capacity adds
  nothing (GShard). Published Mixtral drops nothing.
* Gates are the top-2 softmax probabilities renormalised to sum to one
  (as published); ties go to the lower expert index.
* Router losses (Switch Transformer): load balance ``E * sum_e f_e p_e``
  with ``f_e`` the share of tokens whose first choice is ``e`` and ``p_e``
  the mean router probability, and the z-loss ``mean(logsumexp^2)``, each
  averaged over the layers, added as ``aux_coef * lb + z_coef * z``.
  (HF's auxiliary loss counts both choices and has no z-loss.)
* Next-token cross-entropy over every position but each row's last.

Memory. A step first runs the whole batch forward without gradients, to
fix each layer's routing over all tokens; then each row again with
gradients under that routing, accumulating into the parameters' ``.grad``.
The loss is a sum over tokens once the routing is fixed (the load-balance
term's ``f_e`` carries no gradient), so the rows' gradients add up to the
batch's. So what is held at once is one row's activations beside the
optimizer state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import causal_attention, exact_f32, rms_norm, rotary


def _attention_block(x, w, i, cfg, positions):
    """``x + attention(norm(x))`` for one row ``x`` [S, D]."""
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    h = rms_norm(x, w[f"L{i}.attn_norm"], cfg["rms_norm_eps"])
    q = (h @ w[f"L{i}.wq"].T).view(-1, H, hd)
    k = (h @ w[f"L{i}.wk"].T).view(-1, G, hd)
    v = (h @ w[f"L{i}.wv"].T).view(-1, G, hd)
    q, k = rotary(q, positions, cfg["rope_theta"]), rotary(k, positions, cfg["rope_theta"])
    a = causal_attention(q, k, v, cfg.get("sliding_window"))
    return x + a @ w[f"L{i}.wo"].T


def route(logits: torch.Tensor, top_k: int, capacity: int):
    """Routing of ``logits`` [N, E] (one group): each token's ``top_k``
    experts (ties to the lower index), and whether each (token, choice)
    pair is within its expert's capacity, first choices before second."""
    N, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    expert = order[:, :top_k]                                   # [N, k]
    keep = torch.zeros_like(expert, dtype=torch.bool)
    taken = torch.zeros(E, dtype=torch.long, device=logits.device)
    for j in range(top_k):
        onehot = F.one_hot(expert[:, j], E)                     # [N, E]
        position = (onehot.cumsum(0) - 1 + taken) * onehot      # slot of each pair
        keep[:, j] = position.sum(1) < capacity
        taken += onehot.sum(0)
    return expert, keep


def capacity(num_tokens: int, cfg: dict) -> int:
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    c = math.ceil(k * num_tokens * cfg["capacity_factor"] / E)
    return max(8, -(-c // 8) * 8)


def _moe(h, w, i, cfg, expert, keep):
    """The sparse MLP of the normed tokens ``h`` [n, D] under fixed
    routing: each kept pair's expert output, weighted by its gate."""
    logits = h @ w[f"L{i}.router"]
    probs = torch.softmax(logits, dim=-1)
    gates = probs.gather(1, expert)
    gates = gates / gates.sum(1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg["num_local_experts"]):
        tok, choice = torch.nonzero((expert == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        a = x @ w[f"L{i}.e_gate"][e]
        b = x @ w[f"L{i}.e_up"][e]
        y = (F.silu(a) * b) @ w[f"L{i}.e_down"][e]
        out = out.index_add(0, tok, y * gates[tok, choice][:, None])
    return out, logits, probs


def _route_batch(w, cfg, ids):
    """Without gradients: each layer's routing (``expert``, ``keep``,
    ``top1_share`` [E]) over all of the batch's tokens."""
    B, S = ids.shape
    N = B * S
    C = capacity(N, cfg)
    positions = torch.arange(S, device=ids.device)
    x = w["embed"][ids]                                          # [B, S, D]
    routes = []
    with torch.no_grad():
        for i in range(cfg["num_hidden_layers"]):
            x = torch.stack([_attention_block(x[b], w, i, cfg, positions)
                             for b in range(B)])
            h = rms_norm(x, w[f"L{i}.mlp_norm"], cfg["rms_norm_eps"]).reshape(N, -1)
            expert, keep = route(h @ w[f"L{i}.router"], cfg["num_experts_per_tok"], C)
            top1 = torch.bincount(expert[:, 0], minlength=cfg["num_local_experts"]) / N
            out, _, _ = _moe(h, w, i, cfg, expert, keep)
            x = x + out.view(B, S, -1)
            routes.append((expert.view(B, S, -1), keep.view(B, S, -1), top1.float()))
    return routes


def _row_loss(w, cfg, ids_row, routes, b, N, n_labels):
    """Row ``b``'s part of the batch loss under the fixed routing."""
    S = ids_row.shape[0]
    E, L = cfg["num_local_experts"], cfg["num_hidden_layers"]
    positions = torch.arange(S, device=ids_row.device)
    x = w["embed"][ids_row]
    lb = z = 0.0
    for i in range(L):
        x = _attention_block(x, w, i, cfg, positions)
        h = rms_norm(x, w[f"L{i}.mlp_norm"], cfg["rms_norm_eps"])
        expert, keep, top1 = routes[i]
        out, logits, probs = _moe(h, w, i, cfg, expert[b], keep[b])
        x = x + out
        lb = lb + E * (top1 * probs.sum(0)).sum() / N
        z = z + torch.logsumexp(logits, dim=-1).square().sum() / N
    x = rms_norm(x, w["final_norm"], cfg["rms_norm_eps"])
    logits = x[:-1] @ w["head"].T
    nll = -torch.log_softmax(logits, dim=-1).gather(1, ids_row[1:, None])[:, 0]
    return (nll.sum() / n_labels + cfg["router_aux_loss_coef"] * lb / L
            + cfg["router_z_loss_coef"] * z / L)


def loss_and_grads(w: dict, cfg: dict, ids: torch.Tensor) -> float:
    """The batch loss of ``ids`` [B, S]; its gradients are added into the
    ``.grad`` of the leaves of ``w`` that require one."""
    B, S = ids.shape
    routes = _route_batch(w, cfg, ids)
    total = 0.0
    for b in range(B):
        loss = _row_loss(w, cfg, ids[b], routes, b, B * S, B * (S - 1))
        loss.backward()
        total += float(loss.detach())
    return total


def train(w: dict, cfg: dict, batches: list, hyper: dict, initial) -> dict:
    """``len(batches)`` optimizer steps on the float32 leaves ``w`` (changed
    in place): loss, gradients, the global-norm clip
    ``min(1, max_norm / (norm + 1e-6))`` and AdamW (decoupled decay, bias
    correction, as ``torch.optim.AdamW``) at step ``t``'s rate
    ``lr * min(1, t / warmup_steps)`` (a linear warmup, ``t`` from 1). ``initial()`` yields the
    starting leaves again, a few at a time (the weights are made anew from
    their seed rather than kept). Returns each step's loss, each leaf's norm
    of the first step's clipped gradient, and each leaf's norm of its
    change over all the steps."""
    exact_f32()
    (b1, b2), eps, wd = hyper["betas"], hyper["eps"], hyper["weight_decay"]
    names = sorted(w)
    for n in names:
        w[n].requires_grad_(True)
    m = {n: torch.zeros_like(w[n]) for n in names}
    v = {n: torch.zeros_like(w[n]) for n in names}
    losses, first_grad = [], {}
    for t, ids in enumerate(batches, start=1):
        losses.append(loss_and_grads(w, cfg, ids))
        lr = hyper["lr"] * min(1.0, t / hyper["warmup_steps"])
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(w[n].grad) for n in names])
            factor = torch.clamp(hyper["max_grad_norm"] / (norms.norm() + 1e-6), max=1.0)
            for n in names:
                g = w[n].grad.mul_(factor)
                if t == 1:
                    first_grad[n] = float(torch.linalg.vector_norm(g))
                w[n].mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
                w[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                w[n].grad = None
    del m, v
    change = {}
    with torch.no_grad():
        for group in initial():
            for n, start in group.items():
                change[n] = float(torch.linalg.vector_norm(w[n] - start))
    return {"losses": losses, "first_grad": first_grad, "change": change}
