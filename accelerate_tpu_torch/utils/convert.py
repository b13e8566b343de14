"""Weights between flax parameter trees and the port's state dicts.

The JAX package keeps parameters as nested dicts (``params["model"]
["layers_0"]["self_attn"]["q_proj"]["kernel"]``); the port's modules carry
the same names (``model.layers.0.self_attn.q_proj.weight``). Both Llama
layouts cross: the sequential ``layers_i`` one and the stacked ``blocks``
one of ``PipelinedLlamaForCausalLM``, whose leaves have a leading layer dim.

What changes on the way: flax ``Dense.kernel`` is ``[in, out]`` and
``torch.nn.Linear.weight`` is ``[out, in]`` (the last two dims swap, after
any stacked layer dim); ``Embed.embedding`` becomes ``embed_tokens.weight``;
norm ``scale`` and projection ``bias`` keep name and shape. A tied head has
no ``lm_head`` on either side. Arrays cross as numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _check_layout(keys, config, num_layers):
    has_head = any(path[0] == "lm_head" for path in keys)
    if has_head == bool(config.tie_word_embeddings):
        raise ValueError(f"tie_word_embeddings={config.tie_word_embeddings} but the "
                         f"parameters {'have' if has_head else 'lack'} an lm_head")
    if num_layers != config.num_hidden_layers:
        raise ValueError(f"parameters hold {num_layers} layers, config says "
                         f"{config.num_hidden_layers}")


def state_dict_from_flax(params, config) -> dict:
    """Flax Llama params (nested dicts of arrays, either layout) -> a state
    dict for ``LlamaForCausalLM`` (``layers_i``) or
    ``PipelinedLlamaForCausalLM`` (``blocks``). Float32 CPU tensors."""
    flat = dict(_flatten(params))
    model = params["model"]
    if "blocks" in model:
        num_layers = next(iter(_flatten(model["blocks"])))[1].shape[0]
    else:
        num_layers = sum(1 for key in model if key.startswith("layers_"))
    _check_layout(flat, config, num_layers)
    state = {}
    for path, array in flat.items():
        array = np.asarray(array)
        names = []
        for part in path[:-1]:
            if part.startswith("layers_") and part[len("layers_"):].isdigit():
                names += ["layers", part[len("layers_"):]]
            else:
                names.append(part)
        leaf = path[-1]
        if leaf == "kernel":
            array = np.swapaxes(array, -1, -2)
            leaf = "weight"
        elif leaf == "embedding":
            leaf = "weight"
        state[".".join(names + [leaf])] = torch.from_numpy(np.ascontiguousarray(array))
    return state


def flax_from_state_dict(state_dict) -> dict:
    """Inverse of :func:`state_dict_from_flax`: a port state dict -> flax
    Llama params as nested dicts of float32 numpy arrays."""
    params: dict = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        array = tensor.detach().to("cpu", torch.float32).numpy()
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "layers" and parts[i + 1].isdigit():
                path.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        leaf = parts[-1]
        if leaf == "weight":
            if path[-1] == "embed_tokens":
                leaf = "embedding"
            else:
                array = np.swapaxes(array, -1, -2)
                leaf = "kernel"
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(array)
    return params
