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

Mixtral's raw parameters cross as they are: the router ``[D, E]`` and the
stacked experts (``gate_proj``/``up_proj`` ``[E, D, F]``, ``down_proj``
``[E, F, D]``) keep the JAX layout in the port, so the transpose above is
for ``kernel`` leaves only. (From HF, where each expert is a
``Linear.weight`` ``[out, in]``, the experts are stacked and transposed,
``utils/hf_interop.py``.)

The other families (GPT-2, OPT, GPT-J, GPT-NeoX, Phi, BLOOM, BERT, ViT,
T5, ResNet and the small models) cross by the same rules, their layer lists
named as in flax (``h_<i>``, ``layers_<i>``, BERT's and ViT's ``layer_<i>``,
T5's ``encoder_layer_<i>`` and ``decoder_layer_<i>`` -> ``h.<i>``,
``layers.<i>``, ``layer.<i>``, ``encoder_layer.<i>``, ...). A 4-D ``kernel``
is a flax conv kernel, HWIO, which becomes torch's OIHW (``permute(3, 2, 0,
1)``); ResNet's ``batch_stats`` (``mean``, ``var``) become buffers of the
same names. Bare leaves (ViT's ``cls_token`` and ``position_embeddings``)
keep name and shape; T5's tied head is its ``shared_embedding``.
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


#: The flax names of the families' layer lists (``h_0`` -> ``h.0``).
_LAYER_LISTS = ("layers", "h", "layer", "encoder_layer", "decoder_layer")


def _port_leaf(path, array):
    """``(port name, tensor)`` of one flax leaf outside the Llama family."""
    names = []
    for part in path[:-1]:
        prefix, _, index = part.rpartition("_")
        if prefix in _LAYER_LISTS and index.isdigit():
            names += [prefix, index]
        else:
            names.append(part)
    leaf = path[-1]
    if leaf == "kernel":
        array = np.transpose(array, (3, 2, 0, 1)) if array.ndim == 4 else np.swapaxes(array, -1, -2)
        leaf = "weight"
    elif leaf == "embedding":
        leaf = "weight"
    return ".".join(names + [leaf]), torch.from_numpy(np.array(array, order="C"))


def _family_state_dict(params, config) -> dict:
    """:func:`state_dict_from_flax` for the GPT-style families, BERT, ViT,
    T5, ResNet (its variables, ``params`` and ``batch_stats``, or its params
    alone) and the small models."""
    if "params" in params:
        variables, params = params, params["params"]
        flat = dict(_flatten(params))
        flat.update(_flatten(variables.get("batch_stats", {})))
    else:
        flat = dict(_flatten(params))
    # T5's num_layers counts each of its two stacks.
    layers = getattr(config, "num_hidden_layers", getattr(config, "num_layers", None))
    if layers is not None:
        found: dict = {}
        for path in flat:
            for part in path[:-1]:
                prefix, _, index = part.rpartition("_")
                if prefix in _LAYER_LISTS and index.isdigit():
                    found.setdefault(prefix, set()).add(index)
        for prefix, indices in (found or {"layers": set()}).items():
            if len(indices) != layers:
                raise ValueError(f"parameters hold {len(indices)} {prefix} layers, config "
                                 f"says {layers}")
    return dict(_port_leaf(path, np.asarray(array)) for path, array in flat.items())


def state_dict_from_flax(params, config) -> dict:
    """Flax Llama params (nested dicts of arrays, either layout) -> a state
    dict for ``LlamaForCausalLM`` (``layers_i``) or
    ``PipelinedLlamaForCausalLM`` (``blocks``); flax Mixtral params -> one
    for ``MixtralForCausalLM``; the params of another family's flax model
    (``config`` its config; ResNet's whole variables, ``batch_stats``
    included) -> one for the port's model of that family. Float32 CPU
    tensors."""
    from ..models.llama import LlamaConfig

    if config is None or not isinstance(config, LlamaConfig):
        return _family_state_dict(params, config)
    flat = dict(_flatten(params))
    model = params.get("model", params)  # Mixtral's tree has no "model" scope
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


def _port_name(path) -> str:
    names = []
    for part in path:
        if part.startswith("layers_") and part[len("layers_"):].isdigit():
            names += ["layers", part[len("layers_"):]]
        else:
            names.append(part)
    return ".".join(names)


def adapter_from_flax(tree) -> dict:
    """A JAX package LoRA adapter (nested dicts mirroring the flax params,
    each adapted module ``{"a": [in, r], "b": [r, out], "scale": []}``) ->
    the port's adapter (``{"model.layers.0.self_attn.q_proj": {...}}``),
    float32 CPU tensors. ``a`` and ``b`` keep their orientation."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict) and set(node) == {"a", "b", "scale"}:
            out[_port_name(path)] = {k: torch.from_numpy(np.array(node[k], np.float32))
                                     for k in ("a", "b", "scale")}
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(value, path + (key,))

    walk(tree, ())
    return out


def adapter_to_flax(adapter: dict) -> dict:
    """Inverse of :func:`adapter_from_flax`: nested dicts of float32 numpy
    arrays at the flax paths (``layers.0`` -> ``layers_0``)."""
    tree: dict = {}
    for dotted, module in adapter.items():
        parts = dotted.split(".")
        path, i = [], 0
        while i < len(parts):
            if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        for k in ("a", "b", "scale"):
            node[k] = torch.as_tensor(module[k]).detach().to("cpu", torch.float32).numpy()
    return tree
