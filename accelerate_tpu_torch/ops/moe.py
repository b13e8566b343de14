"""Mixture-of-Experts: top-k routing with a fixed capacity per expert, the
sparse SwiGLU expert layer, and expert parallelism over the mesh's ``ep``
axis.

Counterpart of ``accelerate_tpu/ops/moe.py`` (the GShard / Switch
formulation). The function is the reference's, including which tokens
drop:

* tokens are routed within ``G`` independent groups of ``n``; each expert
  has ``C`` slots a group (:func:`expert_capacity`: a multiple of 8, at
  least 8), and a (token, choice) pair past its expert's capacity is
  dropped (it adds nothing to the output);
* priority is slot-major: every token's first choice outranks any second
  choice, then arrival order within the group;
* the selected gates are renormalised iff ``top_k > 1`` unless
  ``normalize_gates`` says otherwise; router logits are f32, from f32
  tokens, under any compute dtype; top-k ties go to the lower expert index,
  as ``jax.lax.top_k`` orders them;
* the Switch losses (load balance and router z-loss) are over all groups
  jointly.

How tokens move. The reference builds one-hot dispatch and combine tensors
``[G, n, E, C]`` and moves tokens with two einsums. Here they move by
index: each kept (token, choice) pair is gathered into an ``[E, G, C, D]``
buffer at its slot, the experts run as batched matmuls over that buffer,
and each token's output is the gate-weighted sum, in f32, of the rows at
its slots. :func:`top_k_routing` still returns the reference's one-hot
tensors, built from the same routing, for the API and the tests.

Expert parallelism. Under a mesh whose ``ep`` axis spans several
processes the expert leaves hold this process's ``E / ep`` experts
(``parallel/sharding.py``'s stack rule), and the batch is split over the
data axes (dp, fsdp) only, so the ``ep`` processes of a data shard hold the
same tokens. With ``G`` groups over the data shards (by default one group a
``dp x fsdp x ep`` process, :func:`default_num_groups`), what XLA lowers
from the reference's sharding constraints runs here by hand:

* each ``ep`` process routes its share of the shard's groups, sends its
  expert-major buffer through an all-to-all to the owner of each block of
  ``E / ep`` experts, runs its experts on every group's slots, sends the
  results back, combines its groups and all-gathers them over ``ep``, so
  the residual stream stays replicated over ``ep``;
* when the shard's groups do not split over ``ep``, every ``ep`` process
  routes them all, runs its experts on its block of the buffer, and the
  blocks are all-gathered;
* when the groups do not split over the data shards (a group spans
  several), the rows are all-gathered over the data axes first and each
  process keeps its own rows of the output.

Tensor, context and pipeline axes (the JAX package runs the layer under
GSPMD on any mesh, and the results are those of the one-device function):

* ``tp``: the expert leaves hold ``F / tp`` of the hidden width (the JAX
  specs ``("ep", None, "tp")`` for ``gate_proj``/``up_proj`` and ``("ep",
  "tp")`` for ``down_proj``). Every ``tp`` process routes the same groups,
  runs the column products on its slice and the row product on its rows,
  and the partial outputs meet in one all-reduce over ``tp`` after the
  (linear, f32) combine, which moves ``[B, S, D]`` instead of the slots.
  The tokens entering the experts and the gates entering the combine sum
  their gradients over ``tp`` (Megatron's f); the router path computes the
  same on every ``tp`` process, so its gradient is whole on each.
* ``cp``: a routing group is a run of the flattened global ``[B * S]``
  rows, so the sequence chunks are all-gathered over ``cp`` first, every
  ``cp`` process routes the whole rows of its data shard, and each keeps
  its own chunk of the output (the backward reduce-scatters the input's
  gradient). Routing each chunk alone would drop other tokens.
* ``pp``: the Mixtral has no stacked form, so its leaves stay whole over
  ``pp`` and the batch splits over the data axes only: nothing changes.

At an axis of size 1 the ``tp`` and ``cp`` paths run as they are, over
groups of one process, whose collectives return their input.

The autograd functions below make the backward right: the experts'
gradients are whole on their owner; the router's and the input's, partial
on each ``ep`` process, are summed over ``ep``; what every ``ep`` process
computes alike (attention, norms) is not. The router losses sum their
statistics over the processes that routed disjoint groups, and the
backward of that sum sums the incoming gradient over the data axes: the
accelerator weights each data process's loss so that the weights add up to
one (a label share), or averages the gradients, and either way each
process's statistics then get the whole loss's gradient once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import _GatherReplicated, _GatherSplit, _SliceReplicated, _SumGradient


def default_num_groups(num_tokens: int, mesh=None) -> int:
    """One routing group per ``dp x fsdp x ep`` process when that divides
    the token count (of the global batch), else 1. The ``tp``, ``cp`` and
    ``pp`` processes of a data shard share its groups."""
    from ..state import current_mesh

    mesh = current_mesh(mesh)
    if mesh is None:
        return 1
    shape = dict(mesh.shape)
    g = shape.get("dp", 1) * shape.get("fsdp", 1) * shape.get("ep", 1)
    return g if g > 0 and num_tokens % g == 0 else 1


def expert_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert per group, rounded up to a multiple of 8 (at least 8)."""
    cap = int(math.ceil(top_k * tokens_per_group * capacity_factor / num_experts))
    return max(8, -(-cap // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest along the last dim, ties to the lower index (a
    stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, top_k: int, capacity: int, normalize_gates: Optional[bool]):
    """Routing of ``logits`` [G, n, E] (f32) in index form: ``(expert, slot,
    keep, gates, probs)``, the first four [G, n, top_k]: each choice's
    expert, its slot (clamped into the capacity), whether it is kept, and
    its gate (renormalised per :func:`top_k_routing`)."""
    G, n, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, expert = _top_k(probs, top_k)
    if normalize_gates is None:
        normalize_gates = top_k > 1
    if normalize_gates:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # Slot-major arrival order: choice j of every token before choice j+1.
    order = expert.transpose(1, 2).reshape(G, top_k * n)
    seen = F.one_hot(order, E).cumsum(dim=1)
    pos = seen.gather(2, order[..., None])[..., 0] - 1
    pos = pos.reshape(G, top_k, n).transpose(1, 2)
    keep = pos < capacity
    return expert, pos.clamp(max=capacity - 1), keep, gates, probs


def _statistics(logits, probs, expert, num_experts: int) -> torch.Tensor:
    """The router losses' sums over the groups routed here: top-1 counts
    [E], router probabilities [E], squared log-sum-exps [1] and the token
    count [1], in one f32 vector."""
    G, n, _ = logits.shape
    top1 = F.one_hot(expert[..., 0], num_experts).to(torch.float32).sum((0, 1))
    z = (torch.logsumexp(logits, dim=-1) ** 2).sum()
    count = torch.full((1,), float(G * n), dtype=torch.float32, device=logits.device)
    return torch.cat([top1, probs.sum((0, 1)), z.reshape(1), count])


def _losses(stats: torch.Tensor, num_experts: int) -> dict:
    E = num_experts
    count = stats[-1]
    fraction = stats[:E] / count
    prob_mean = stats[E:2 * E] / count
    return {"load_balance_loss": E * torch.sum(fraction * prob_mean),
            "router_z_loss": stats[2 * E] / count,
            "expert_fraction": fraction}


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int, *,
                  normalize_gates: Optional[bool] = None):
    """GShard top-k routing with per-expert capacity (reference
    ``accelerate_tpu/ops/moe.py:57-119``).

    Args:
      router_logits: ``[groups, tokens, experts]``.
      top_k: experts per token (1 = Switch, 2 = Mixtral).
      capacity: slots per expert per group.
      normalize_gates: renormalise the selected top-k probabilities to sum
        to one per token; default True iff ``top_k > 1`` (with one choice
        the gate would always be 1 and the router would get no gradient from
        the task loss).

    Returns ``(dispatch, combine, aux)``: ``dispatch`` ``[G, n, E, C]``
    {0, 1} (f32), ``combine`` ``[G, n, E, C]`` f32 (the gate at the
    assigned slot), and ``aux`` with ``load_balance_loss``,
    ``router_z_loss`` and ``expert_fraction`` ``[E]``. :func:`moe_mlp_apply`
    moves tokens from the same routing by index and builds neither."""
    G, n, E = router_logits.shape
    logits = router_logits.float()
    expert, slot, keep, gates, probs = _route(logits, top_k, capacity, normalize_gates)
    index = (expert * capacity + slot).reshape(G, n, top_k)
    kept = keep.to(torch.float32)
    zeros = torch.zeros((G, n, E * capacity), dtype=torch.float32, device=logits.device)
    dispatch = zeros.scatter_add(2, index, kept).view(G, n, E, capacity)
    combine = zeros.scatter_add(2, index, gates * kept).view(G, n, E, capacity)
    return dispatch, combine, _losses(_statistics(logits, probs, expert, E), E)


# ---------------------------------------------------------------------------
# Collectives with the backward expert parallelism needs (the others are
# parallel/sharding.py's)
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``AxisGroup.all_to_all``: piece ``j`` along ``split_dim`` to process
    ``j``, the pieces received concatenated along ``concat_dim``; the
    backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(t, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return ctx.group.all_to_all(grad.contiguous(), concat_dim, split_dim), None, None, None


class _SumStatistics(torch.autograd.Function):
    """The sum over ``forward_group`` (None: this process alone), whose
    backward sums the gradient over ``backward_group``."""

    @staticmethod
    def forward(ctx, t, forward_group, backward_group):
        ctx.group = backward_group
        out = t.clone()
        return forward_group.all_reduce(out) if forward_group is not None else out

    @staticmethod
    def backward(ctx, grad):
        if ctx.group is None:
            return grad, None, None
        return ctx.group.all_reduce(grad.contiguous().clone()), None, None


def _tp_split(mesh, local: int, full: Optional[int]):
    """The mesh's ``tp`` group when the expert leaves hold ``local`` of
    the ``full`` hidden width split over it (a group of one at a ``tp``
    axis of 1), None when they are whole."""
    if mesh is None or full is None:
        return None
    size = mesh.shape.get("tp", 1)
    if local == full and size > 1:
        return None
    if local * size != full:
        raise ValueError(f"experts of width {local} of {full} do not split over the mesh's "
                         f"tp axis ({size})")
    return mesh.group("tp")


def _group(mesh, *axes):
    """The mesh's group over ``axes`` when it spans several processes."""
    if mesh is None or mesh.size(axes) == 1:
        return None
    return mesh.group(*axes)


# ---------------------------------------------------------------------------
# The expert layer
# ---------------------------------------------------------------------------

def _uniform(source, shape, device) -> torch.Tensor:
    """Uniform [0, 1) noise of ``shape``: a hash of (key, element index),
    the key an int64 tensor (the same noise again when a checkpointed layer
    is recomputed) or drawn from a ``torch.Generator``."""
    from ..generation import _M32, _hash32

    if isinstance(source, torch.Generator):
        source = torch.randint(0, 2**62, (), generator=source, device=source.device)
    key = torch.as_tensor(source, device=device).to(torch.int64)
    row = _hash32(_hash32(key & _M32) ^ ((key >> 32) & _M32))
    index = torch.arange(math.prod(shape), device=device, dtype=torch.int64)
    bits = _hash32(row ^ _hash32((index + 0x9E3779B9) & _M32))
    return ((bits >> 8).to(torch.float32) * (2.0 ** -24)).reshape(shape)


def _slots(expert, slot, groups: int, capacity: int) -> torch.Tensor:
    """Each (token, choice)'s row in the ``[E * groups * C]`` slot buffer."""
    g = torch.arange(groups, device=expert.device)[:, None, None]
    return (expert * groups + g) * capacity + slot


def _dispatch(tokens, rows, keep, num_experts: int, capacity: int) -> torch.Tensor:
    """``[E, G, C, D]``: each kept (token, choice) pair's token at its slot,
    zeros in the empty slots. A gather through a slot -> token index, whose
    empty slots name a zero row past the tokens."""
    G, n, D = tokens.shape
    size = num_experts * G * capacity
    source = torch.arange(G * n, device=tokens.device).view(G, n, 1).expand_as(rows)
    index = torch.full((size + 1,), G * n, dtype=torch.int64, device=tokens.device)
    index.scatter_(0, torch.where(keep, rows, size).reshape(-1), source.reshape(-1))
    padded = torch.cat([tokens.reshape(G * n, D), tokens.new_zeros(1, D)])
    return padded[index[:size]].view(num_experts, G, capacity, D)


def _combine(out_e, rows, keep, gates) -> torch.Tensor:
    """``[G, n, D]`` f32: each token's gate-weighted sum of its kept slots'
    rows (a dropped choice weighs 0)."""
    E, G, C, D = out_e.shape
    n, k = rows.shape[1], rows.shape[2]
    picked = out_e.reshape(E * G * C, D)[rows.reshape(-1)].view(G, n, k, D).float()
    return (picked * (gates * keep)[..., None]).sum(2)


def _expert_mlp(h, wg, wu, wd) -> torch.Tensor:
    """SwiGLU experts on ``h`` [E, G, C, D]: batched matmuls over the
    experts."""
    E, G, C, D = h.shape
    x = h.reshape(E, G * C, D)
    a = torch.bmm(x, wg.to(h.dtype))
    b = torch.bmm(x, wu.to(h.dtype))
    return torch.bmm(F.silu(a) * b, wd.to(h.dtype)).view(E, G, C, wd.shape[-1])


def moe_mlp_apply(expert_params: dict, router_kernel: torch.Tensor, x: torch.Tensor, *,
                  top_k: int, capacity_factor: float, num_groups: Optional[int] = None,
                  mesh=None, router_noise_rng=None, router_noise_eps: float = 0.0,
                  normalize_gates: Optional[bool] = None,
                  intermediate_size: Optional[int] = None):
    """Sparse expert MLP over ``x`` [batch, seq, d_model] (reference
    ``accelerate_tpu/ops/moe.py:148-203``).

    ``expert_params``: ``gate_proj``/``up_proj`` ``[E, D, F]`` and
    ``down_proj`` ``[E, F, D]``, stacked expert-major, or this process's
    ``E / ep`` of them on a mesh with an ``ep`` axis. ``router_kernel``:
    ``[D, E]``. ``num_groups``: routing groups over the global batch
    (default :func:`default_num_groups`). ``router_noise_rng``: a
    ``torch.Generator`` or an int64 key tensor for the multiplicative
    jitter ``U[1 - eps, 1 + eps)`` on the logits (with
    ``router_noise_eps > 0``). ``intermediate_size``: the experts' whole
    hidden width ``F``; the leaves holding ``F / tp`` of it are this
    process's ``tp`` chunks (None: the leaves are whole).

    Returns ``(out [batch, seq, d_model], aux)``: ``aux`` holds the
    reference's ``load_balance_loss``, ``router_z_loss`` and
    ``expert_fraction``, and two counters of the groups this process
    routed: ``expert_load`` [E] (kept pairs per expert) and
    ``dropped_fraction`` (the share of pairs dropped)."""
    from ..state import current_mesh

    mesh = current_mesh(mesh)
    wg, wu, wd = expert_params["gate_proj"], expert_params["up_proj"], expert_params["down_proj"]
    E = router_kernel.shape[-1]
    tp = _tp_split(mesh, wg.shape[-1], intermediate_size)
    cp = mesh.group("cp") if mesh is not None else None
    chunk = x.shape[1]
    if cp is not None:  # whole rows: a group is a run of the global [B * S]
        x = _GatherSplit.apply(x, cp, 1)
    B, S, D = x.shape
    data = _group(mesh, "dp", "fsdp")
    ep = None
    if wg.shape[0] != E:
        ep = _group(mesh, "ep")
        if ep is None or wg.shape[0] * ep.size != E:
            raise ValueError(f"{wg.shape[0]} experts here of {E} do not split over the mesh's "
                             f"ep axis ({None if ep is None else ep.size})")
    shards = data.size if data is not None else 1
    N = B * S * shards
    G = num_groups if num_groups is not None else default_num_groups(N, mesh)
    if N % G != 0:
        raise ValueError(f"tokens {N} not divisible by num_groups {G}")
    n = N // G
    C = expert_capacity(n, E, top_k, capacity_factor)

    tokens = x.reshape(B * S, D)
    spans = data is not None and G % data.size != 0
    if spans:  # a group spans data shards: route the global batch here
        tokens = _GatherSplit.apply(tokens, data, 0)
    groups = G if spans else G // shards
    tokens = tokens.reshape(groups, n, D)
    split = ep is not None and groups % ep.size == 0
    router = router_kernel
    if split:  # this ep process routes its share of the groups
        tokens = _SliceReplicated.apply(tokens, ep, 0, groups // ep.size)
        router = _SumGradient.apply(router_kernel, ep)
    local = tokens.shape[0]

    logits = tokens.float() @ router.float()
    if router_noise_rng is not None and router_noise_eps > 0.0:
        noise = _uniform(router_noise_rng, logits.shape, logits.device)
        logits = logits * (1.0 - router_noise_eps + 2.0 * router_noise_eps * noise)
    expert, slot, keep, gates, probs = _route(logits, top_k, C, normalize_gates)

    stats = _statistics(logits, probs, expert, E)
    forward_group = None if spans else data
    if split:
        forward_group = _group(mesh, "ep") if spans else _group(mesh, "dp", "fsdp", "ep")
    backward_group = None if spans else data
    if forward_group is not None or backward_group is not None:
        stats = _SumStatistics.apply(stats, forward_group, backward_group)
    aux = _losses(stats, E)
    with torch.no_grad():
        aux["expert_load"] = torch.zeros(E, device=x.device).index_add_(
            0, expert.reshape(-1), keep.reshape(-1).to(torch.float32))
        # A count over the total: exactly 0 when nothing drops (a mean's
        # reciprocal multiply need not give exactly 1).
        aux["dropped_fraction"] = (~keep).sum().to(torch.float32) / keep.numel()

    rows = _slots(expert, slot, local, C)
    if tp is not None:  # each tp process uses the tokens and gates on its F / tp
        tokens = _SumGradient.apply(tokens, tp)
        gates = _SumGradient.apply(gates, tp)
    expert_in = _dispatch(tokens, rows, keep, E, C)
    if ep is None:
        out_e = _expert_mlp(expert_in, wg, wu, wd)
    elif split:  # to the owners of each block of experts, and back
        mine = _AllToAll.apply(expert_in, ep, 0, 1)
        out_e = _AllToAll.apply(_expert_mlp(mine, wg, wu, wd), ep, 1, 0)
    else:  # every ep process routed every group: run this block of experts
        mine = _SliceReplicated.apply(expert_in, ep, 0, wg.shape[0])
        out_e = _GatherReplicated.apply(_expert_mlp(mine, wg, wu, wd), ep, 0)
    out = _combine(out_e, rows, keep, gates)
    if tp is not None:  # the partial sums over the F / tp slices
        out = _SumStatistics.apply(out, tp, None)
    out = out.to(x.dtype)
    if split:
        out = _GatherReplicated.apply(out, ep, 0)
    out = out.reshape(-1, D)
    if spans:
        out = out.narrow(0, data.index * B * S, B * S)
    out = out.reshape(B, S, D)
    if cp is not None:
        out = out.narrow(1, cp.index * chunk, chunk)
    return out, aux
