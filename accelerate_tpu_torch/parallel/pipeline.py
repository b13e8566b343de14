"""Pipeline parallelism over the mesh's ``pp`` axis: the GPipe schedule.

Counterpart of ``accelerate_tpu/parallel/pipeline.py``. The JAX package
stacks the layers' parameters on a leading ``[L, ...]`` axis split over
``pp`` and runs the schedule as one differentiable ``lax.scan`` over
``M + pp - 1`` ticks, whose roll along the stage axis XLA lowers to a
collective-permute. Here each process of the ``pp`` group is one stage and
holds its ``L / pp`` layers (the accelerator stores the stacked leaves
split over dim 0, ``parallel/sharding.py``); the schedule is the same:

* the batch is split into ``M`` microbatches (default ``pp``); stage ``s``
  works on microbatch ``m`` at tick ``s + m``, so a pass takes
  ``M + pp - 1`` ticks and the bubble is ``(pp - 1) / (M + pp - 1)``;
* activations pass from stage ``s`` to ``s + 1`` by send/recv inside
  autograd functions (:class:`_SendActivation`, :class:`_RecvActivation`),
  whose backward sends the activations' gradients back the other way, so
  the backward is the pipeline reversed, microbatch by microbatch;
* the input enters on stage 0 and the last stage's output is broadcast to
  every stage (:class:`_PipelineBoundary`), so what runs before and after
  the pipeline (embedding, norm, head, loss) runs the same on every stage
  and every leaf the ``pp`` axis does not split gets the same gradient on
  every stage (the input's gradient is broadcast from stage 0);
* ``extras`` (positions, segment ids) ride along: each stage takes the
  microbatch's slice of them itself.

Only GPipe: the ``"1f1b"`` schedule the plugin declares is read by no code
of the JAX package either. With a ``pp`` axis of one process the layers
run in a plain loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def _resolve_mesh(mesh):
    from ..state import current_mesh

    return current_mesh(mesh)


def num_layers_of(stacked_params) -> int:
    """The leading (layer) dim every leaf of a stacked mapping shares."""
    leaves = list(stacked_params.values()) if isinstance(stacked_params, dict) \
        else list(stacked_params)
    if not leaves:
        raise ValueError("empty stacked params")
    L = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != L:
            raise ValueError(f"stacked params leaves disagree on layer dim: {leaf.shape[0]} "
                             f"vs {L}")
    return L


class _RecvActivation(torch.autograd.Function):
    """A microbatch's activations from the previous stage; the backward
    sends their gradient back to it. ``anchor`` (a scalar that requires
    grad) puts the received tensor in the graph."""

    @staticmethod
    def forward(ctx, anchor, group, shape, dtype):
        ctx.group = group
        return group.recv(shape, dtype, anchor.device, group.index - 1)

    @staticmethod
    def backward(ctx, grad):
        ctx.group.send(grad, ctx.group.index - 1)
        return None, None, None, None


class _SendActivation(torch.autograd.Function):
    """Send a microbatch's activations to the next stage; returns a token
    (a zero) whose backward receives their gradient from it."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group, ctx.shape, ctx.dtype = group, h.shape, h.dtype
        group.send(h.detach(), group.index + 1)
        return torch.zeros((), dtype=torch.float32, device=h.device)

    @staticmethod
    def backward(ctx, token_grad):
        g = ctx.group.recv(ctx.shape, ctx.dtype, token_grad.device, ctx.group.index + 1)
        return g, None


class _ReplicatedInput(torch.autograd.Function):
    """The pipeline's input, which every stage holds and stage 0 feeds in:
    the backward broadcasts stage 0's gradient, so every stage holds it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous() if ctx.group.index == 0 else torch.zeros_like(grad)
        return ctx.group.broadcast(grad, 0), None


class _PipelineBoundary(torch.autograd.Function):
    """The last stage's output broadcast to every stage. Backward: the last
    stage takes the gradient into its pipeline; every other stage starts
    the backward of its sends (the tokens) and of the input (zeros)."""

    @staticmethod
    def forward(ctx, out, x, group, *tokens):
        ctx.group, ctx.n, ctx.x_shape = group, len(tokens), x.shape
        last = group.index == group.size - 1
        result = out.detach().clone() if last else out
        return group.broadcast(result.contiguous(), group.size - 1)

    @staticmethod
    def backward(ctx, grad):
        last = ctx.group.index == ctx.group.size - 1
        zero = torch.zeros((), dtype=torch.float32, device=grad.device)
        return (grad if last else None, grad.new_zeros(ctx.x_shape), None, *([zero] * ctx.n))


def _split(tree, M: int):
    """``tree`` (a tensor, a tuple of them, or None) cut into ``M``
    microbatches along dim 0: a list of ``M`` trees."""
    if tree is None:
        return [None] * M
    if isinstance(tree, (tuple, list)):
        parts = [_split(t, M) for t in tree]
        return [type(tree)(p[m] for p in parts) for m in range(M)]
    return list(tree.chunk(M, dim=0))


def pipeline_apply(block_fn: Callable, stacked_params, x: torch.Tensor, extras=None, *,
                   mesh=None, num_microbatches: Optional[int] = None, remat: bool = False,
                   remat_policy=None):
    """Run ``x`` through the stacked layers under the GPipe schedule
    (reference ``:82-211``).

    ``block_fn(layer_params, h, extras) -> h`` is one layer;
    ``stacked_params`` maps names to the ``[layers, ...]`` tensors this
    process holds: with a ``pp`` axis above one process, its stage's
    ``L / pp`` layers. ``extras``: a tensor or tuple of tensors (or None)
    with ``x``'s batch dim, which ride along. ``num_microbatches``: ``M``
    (default ``pp``), which must divide the batch. ``remat`` checkpoints
    each layer (``remat_policy`` "everything" keeps it all). Every stage
    returns the last layer's ``[batch, ...]`` output."""
    mesh = _resolve_mesh(mesh)
    pp = mesh.shape.get("pp", 1) if mesh is not None else 1
    num_layers_of(stacked_params)  # every leaf has the layer dim
    if remat and str(getattr(remat_policy, "value", remat_policy)) != "everything":
        def body(p, h, exs):
            return checkpoint(block_fn, p, h, exs, use_reentrant=False)
    else:
        body = block_fn

    def layers(h, exs):
        # One unbind per stacked tensor, not an index per layer: its backward
        # stacks the layers' gradients in one write.
        for values in zip(*(t.unbind(0) for t in stacked_params.values())):
            h = body(dict(zip(stacked_params, values)), h, exs)
        return h

    if pp <= 1:
        return layers(x, extras)
    M = int(num_microbatches or pp)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch={B} not divisible by num_microbatches={M}")
    group = mesh.group("pp")
    stage, last = group.index, group.size - 1
    x_in = _ReplicatedInput.apply(x, group) if x.requires_grad else x
    x_mb, ex_mb = list(x_in.chunk(M, dim=0)), _split(extras, M)
    anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    for m in range(M):
        h = x_mb[m] if stage == 0 else _RecvActivation.apply(anchor, group, x_mb[m].shape,
                                                             x.dtype)
        h = layers(h, ex_mb[m])
        if stage < last:
            tokens.append(_SendActivation.apply(h, group))
        else:
            outs.append(h)
    out = torch.cat(outs, dim=0) if stage == last else torch.empty_like(x)
    return _PipelineBoundary.apply(out, x_in, group, *tokens)


# ---------------------------------------------------------------------------
# Sequential <-> stacked parameter layout
# ---------------------------------------------------------------------------

def stack_layer_params(params: dict, prefix: str = "layers.") -> tuple:
    """``{prefix}0.* .. {prefix}{L-1}.*`` entries of a state dict stacked
    into ``[L, ...]`` tensors: ``(stacked, rest)``, ``stacked`` by the name
    under the layer (``self_attn.q_proj.weight``), ``rest`` the other
    entries unchanged. Converts between the sequential layout
    (``LlamaForCausalLM``'s ``model.layers.<i>``, with ``prefix``
    ``"model.layers."``) and the pipelined one."""
    per: dict = {}
    rest = {}
    for name, tensor in params.items():
        if name.startswith(prefix):
            index, _, leaf = name[len(prefix):].partition(".")
            if index.isdigit() and leaf:
                per.setdefault(leaf, {})[int(index)] = tensor
                continue
        rest[name] = tensor
    if not per:
        raise ValueError(f"no '{prefix}N' entries in {list(params)}")
    stacked = {}
    for leaf, layers in per.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"non-contiguous layer keys for {leaf}: {sorted(layers)}")
        stacked[leaf] = torch.stack([layers[i] for i in range(len(layers))])
    return stacked, rest


def unstack_layer_params(stacked: dict, prefix: str = "layers.") -> dict:
    """Inverse of :func:`stack_layer_params`: ``[L, ...]`` tensors ->
    ``{prefix}<i>.<name>`` entries."""
    L = num_layers_of(stacked)
    return {f"{prefix}{i}.{leaf}": tensor[i] for i in range(L)
            for leaf, tensor in stacked.items()}
