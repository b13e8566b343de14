"""Stage-parallel (pipelined) inference.

Counterpart of ``accelerate_tpu/inference.py``. A pipelined model
(``PipelinedLlamaForCausalLM``, whose forward runs the GPipe schedule of
``parallel/pipeline.py`` when its stacked layers are split over a ``pp``
axis) is the split and the schedule; this module adds the user-facing
wrapper:

* microbatch padding: a batch of any size is edge-padded to a multiple of
  the microbatch count and the outputs are cut back after the forward;
* an inference-mode forward under the model's precision policy, inside the
  mesh's ``with`` block;
* :func:`resolve_model_source`, which unwraps a prepared model, a module
  or an ``apply_fn(params, *args)`` callable, shared with the serving
  engine's spelling in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from .utils.operations import recursively_apply


def _leaves(tree) -> list:
    out = []
    recursively_apply(lambda t: out.append(t), tree, test_type=torch.is_tensor)
    return out


def pad_batch_to_multiple(args, multiple: int):
    """Edge-pad the leading (batch) dim of every tensor of ``args`` (nested
    lists, tuples and dicts) whose batch is the first tensor's up to a
    multiple of ``multiple``: the padding rows repeat the last one. Returns
    ``(padded_args, original_batch)`` (batch None without a tensor)."""
    leaves = [t for t in _leaves(args) if t.dim() > 0]
    if not leaves:
        return args, None
    batch = leaves[0].shape[0]
    rem = batch % multiple
    if rem == 0:
        return args, batch
    pad = multiple - rem

    def _pad(t):
        if t.dim() == 0 or t.shape[0] != batch:
            return t
        return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])], dim=0)

    return recursively_apply(_pad, args, test_type=torch.is_tensor), batch


class PipelinedInferencer:
    """Callable wrapper: the padded, inference-mode, stage-parallel forward
    ``apply_fn(params, *args, **kwargs)`` over ``params`` (a mapping of
    tensors, or a callable giving one at each call), cast to the
    ``policy``'s compute dtype and its output to the output dtype, inside
    ``mesh`` (when given)."""

    def __init__(self, apply_fn: Callable, params, num_microbatches: int, policy=None,
                 mesh=None):
        self.apply_fn = apply_fn
        self.params = params
        self.num_microbatches = int(num_microbatches)
        self.policy = policy
        self.mesh = mesh

    def __call__(self, *args, **kwargs):
        # Args and kwargs are padded as one tree, so batch tensors passed by
        # keyword (positions, segment ids) stay aligned with the inputs.
        (args, kwargs), batch = pad_batch_to_multiple((args, kwargs), self.num_microbatches)
        ctx = self.mesh if self.mesh is not None else contextlib.nullcontext()
        with torch.inference_mode(), ctx:
            params = self.params() if callable(self.params) else self.params
            if self.policy is not None:
                params = self.policy.cast_to_compute(params)
            out = self.apply_fn(params, *args, **kwargs)
            if self.policy is not None:
                out = self.policy.cast_to_output(out)
        if batch is None:
            return out
        padded = batch + (-batch) % self.num_microbatches
        if padded == batch:
            return out
        return recursively_apply(
            lambda t: t[:batch] if t.dim() > 0 and t.shape[0] == padded else t, out,
            test_type=torch.is_tensor)


def resolve_model_source(model, params=None, accelerator=None):
    """``(module, apply_fn, params, mesh, policy)`` from any spelling of a
    model: a prepared model (``AcceleratedModel``: its module, the
    parameters as its layout hands them to a forward, its policy), an
    ``nn.Module`` (``functional_call`` over its parameters and buffers),
    or an ``apply_fn(params, *args)`` callable (``module`` None, ``params``
    as given). The mesh and policy come from ``accelerator`` when given."""
    from torch import nn

    module = None
    if hasattr(model, "module") and hasattr(model, "policy"):  # AcceleratedModel
        module = model.module
        if params is None:
            from .accelerator import _compute_params

            def params(m=model):
                return {**dict(m.module.named_buffers()),
                        **_compute_params(m.module, m.policy.compute_dtype, m.layout)}
    elif isinstance(model, nn.Module):
        module = model
        if params is None:
            params = {**dict(model.named_buffers()), **dict(model.named_parameters())}
    elif not callable(model):
        raise TypeError(f"cannot resolve a model from {type(model)}")
    if module is not None:
        def apply_fn(p, *args, m=module, **kwargs):
            return torch.func.functional_call(m, p, args, kwargs)
    else:
        apply_fn = model
    policy = accelerator.policy if accelerator is not None else getattr(model, "policy", None)
    mesh = accelerator.mesh if accelerator is not None else getattr(model, "mesh", None)
    return module, apply_fn, params, mesh, policy


def prepare_pipeline(model, params=None, accelerator=None,
                     num_microbatches: Optional[int] = None) -> PipelinedInferencer:
    """A stage-parallel inference callable that takes a batch of any size
    (reference ``prepare_pippy``). ``model``: a pipelined model, prepared
    or not, or an ``apply_fn(params, *args)`` (then ``params`` is needed).
    The microbatch count defaults to the model's, then the accelerator's
    pipeline plugin's, then the ``pp`` axis size, else 1."""
    module, apply_fn, params, mesh, policy = resolve_model_source(
        model, params=params, accelerator=accelerator)
    if params is None:
        raise ValueError("prepare_pipeline needs params (pass params= or a module)")
    if num_microbatches is None:
        num_microbatches = getattr(module if module is not None else model,
                                   "num_microbatches", None)
        if num_microbatches is None and accelerator is not None:
            pp_plugin = accelerator.state.pp_plugin
            if pp_plugin is not None and pp_plugin.num_microbatches > 1:
                num_microbatches = pp_plugin.num_microbatches
        if num_microbatches is None and mesh is not None:
            num_microbatches = max(dict(mesh.shape).get("pp", 1), 1)
        if num_microbatches is None:
            num_microbatches = 1
    return PipelinedInferencer(apply_fn, params, num_microbatches, policy=policy, mesh=mesh)


#: The reference's name for :func:`prepare_pipeline`.
prepare_pippy = prepare_pipeline
