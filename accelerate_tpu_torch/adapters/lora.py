"""LoRA core: config, init, merge, and the low-rank application path.

Counterpart of ``accelerate_tpu/adapters/lora.py``. One adapter is a dict
from the dotted name of each adapted projection of the port's model
(``model.layers.0.self_attn.q_proj``) to ``{"a": [in, r], "b": [r, out],
"scale": []}``. ``a`` and ``b`` keep the JAX orientation (the flax kernel
is ``[in, out]``): the delta is ``((x @ a) @ b) * scale``, added to the
projection's output, and ``a @ b`` is never formed except by
:func:`merge_adapter`, offline. Adapters cross from the JAX package through
numpy (``utils.convert.adapter_from_flax``); the flax tree nests the same
path with ``layers_0`` for ``layers.0``.

Training (:func:`prepare_lora`) freezes the base with
``requires_grad_(False)`` and hands the optimizer only the adapter's
factors, which is what ``optax.masked`` does in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import fnmatch
from typing import Optional, Sequence

import torch
from torch import nn

#: Llama-family projection names; the default covers attention and MLP.
DEFAULT_TARGET_MODULES = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

#: Leaf names of one adapter module, in stacking order.
ADAPTER_LEAVES = ("a", "b", "scale")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Hyperparameters and the modules to adapt. ``target_modules`` are
    fnmatch patterns: one with a ``.`` or ``/`` matches the module's whole
    dotted name (``model.layers.0.self_attn.q_proj``), any other its own
    name (``q_proj``)."""

    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: Sequence[str] = DEFAULT_TARGET_MODULES

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"LoRA rank must be >= 1 (got {self.rank})")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1) (got {self.dropout})")
        if not self.target_modules:
            raise ValueError("target_modules must not be empty")
        object.__setattr__(self, "target_modules", tuple(self.target_modules))

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _matches(dotted: str, patterns: Sequence[str]) -> bool:
    name = dotted.rsplit(".", 1)[-1]
    for pat in patterns:
        if "." in pat or "/" in pat:
            if fnmatch.fnmatch(dotted, pat.replace("/", ".")):
                return True
        elif fnmatch.fnmatch(name, pat):
            return True
    return False


def _projections(model: nn.Module):
    """(dotted name, in_features, out_features) of every linear projection
    of ``model`` (``nn.Linear``, or a quantized one with those attributes)."""
    for name, mod in getattr(model, "module", model).named_modules():
        if name and hasattr(mod, "in_features") and hasattr(mod, "out_features"):
            yield name, int(mod.in_features), int(mod.out_features)


def target_paths(model: nn.Module, config: LoRAConfig) -> list:
    """Dotted names of the projections a :class:`LoRAConfig` adapts, sorted.
    Embeddings and norms never match."""
    found = sorted(name for name, _, _ in _projections(model)
                   if _matches(name, config.target_modules))
    if not found:
        raise ValueError(f"target_modules {tuple(config.target_modules)!r} matched nothing "
                         "in the model")
    return found


def _shapes(model: nn.Module) -> dict:
    return {name: (d_in, d_out) for name, d_in, d_out in _projections(model)}


def init_lora_params(generator: Optional[torch.Generator], model: nn.Module,
                     config: LoRAConfig, dtype=torch.float32) -> dict:
    """A fresh adapter for ``model`` on its device: ``a ~ N(0, 1) / r``,
    ``b = 0``, so the initial delta is exactly zero (training starts from
    the base model)."""
    shapes = _shapes(model)
    device = next(model.parameters()).device
    adapter = {}
    for dotted in target_paths(model, config):
        d_in, d_out = shapes[dotted]
        a = torch.randn((d_in, config.rank), generator=generator, dtype=dtype, device=device)
        adapter[dotted] = {"a": a / config.rank,
                           "b": torch.zeros((config.rank, d_out), dtype=dtype, device=device),
                           "scale": torch.tensor(config.scale, dtype=dtype, device=device)}
    return adapter


def is_adapter_module(node) -> bool:
    return isinstance(node, dict) and set(node) == set(ADAPTER_LEAVES)


def adapter_module_paths(adapter: dict) -> list:
    """Dotted names of every ``{"a", "b", "scale"}`` module of ``adapter``."""
    return sorted(k for k, v in adapter.items() if is_adapter_module(v))


def adapter_rank(adapter: dict) -> int:
    ranks = [adapter[p]["a"].shape[-1] for p in adapter_module_paths(adapter)]
    if not ranks:
        raise ValueError("not an adapter: no {'a','b','scale'} modules found")
    return int(max(ranks))


def pad_adapter(adapter: dict, rank: int) -> dict:
    """Zero-pad every module to ``rank`` (``a``: columns, ``b``: rows):
    ``a @ b`` is unchanged, so adapters of lower ranks share a bank."""
    out = {}
    for dotted in adapter_module_paths(adapter):
        node = adapter[dotted]
        r = node["a"].shape[-1]
        if r > rank:
            raise ValueError(f"adapter rank {r} exceeds bank rank {rank}")
        a = torch.nn.functional.pad(torch.as_tensor(node["a"]), (0, rank - r))
        b = torch.nn.functional.pad(torch.as_tensor(node["b"]), (0, 0, 0, rank - r))
        out[dotted] = {"a": a, "b": b, "scale": torch.as_tensor(node["scale"])}
    return out


def lora_delta(x: torch.Tensor, module: dict, dtype=None) -> torch.Tensor:
    """The low-rank delta ``((x @ a) @ b) * scale``; ``a @ b`` is never
    formed. Factors with a leading batch dim (``a`` [B, in, r], ``scale``
    [B]) give each row of ``x`` [B, S, in] its own adapter."""
    dtype = dtype or x.dtype
    a, b, scale = (module[k].to(dtype) for k in ADAPTER_LEAVES)
    if scale.dim() == 1:
        scale = scale[:, None, None]
    return ((x @ a) @ b) * scale


def merge_adapter(model, adapter: dict):
    """Fold an adapter into the weights, ``W += (a @ b * scale)^T`` in f32
    (``W`` is ``[out, in]``): offline only (single-tenant export, exactness
    references); serving applies the delta per token instead. ``model`` is
    a module (a merged deep copy is returned) or a state dict (a merged
    copy of the dict)."""
    if isinstance(model, dict):
        out = dict(model)
        for dotted in adapter_module_paths(adapter):
            out[f"{dotted}.weight"] = _merged(out[f"{dotted}.weight"], adapter[dotted])
        return out
    merged = copy.deepcopy(model)
    with torch.no_grad():
        for dotted in adapter_module_paths(adapter):
            weight = merged.get_submodule(dotted).weight
            weight.copy_(_merged(weight, adapter[dotted]))
    return merged


def _merged(weight: torch.Tensor, mod: dict) -> torch.Tensor:
    a, b, scale = (torch.as_tensor(mod[k]).to(weight.device) for k in ADAPTER_LEAVES)
    delta = (a @ b) * scale
    return (weight.float() + delta.float().T).to(weight.dtype)


@dataclasses.dataclass
class LoRATrainState:
    """The frozen-base / trainable-adapter split of :func:`prepare_lora`:
    ``model`` has ``requires_grad`` off on every parameter; ``adapter`` is
    applied at call time, ``model(ids, lora=state.adapter)``."""

    model: nn.Module
    adapter: dict
    config: LoRAConfig

    def trainable_parameters(self) -> list:
        """The adapter's ``a`` and ``b`` factors (``scale`` is a frozen
        hyperparameter), in :func:`adapter_module_paths` order."""
        return [self.adapter[p][k] for p in adapter_module_paths(self.adapter) for k in ("a", "b")]

    def wrap_optimizer(self, factory):
        """``factory(params)`` (an optimizer class or a partial of one) over
        the trainable factors only: the base never sees an update."""
        return factory(self.trainable_parameters())


def prepare_lora(model: nn.Module, config: LoRAConfig,
                 generator: Optional[torch.Generator] = None) -> LoRATrainState:
    """Freeze ``model`` and build a fresh trainable adapter on its device::

        state = prepare_lora(model, LoRAConfig(rank=8))
        opt = state.wrap_optimizer(functools.partial(torch.optim.AdamW, lr=1e-4))
        loss = loss_of(model(ids, lora=state.adapter))
    """
    module = getattr(model, "module", model)
    module.requires_grad_(False)
    device = next(module.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    adapter = init_lora_params(generator, module, config)
    for mod in adapter.values():
        mod["a"].requires_grad_(True)
        mod["b"].requires_grad_(True)
    return LoRATrainState(model=model, adapter=adapter, config=config)


def count_lora_params(model: nn.Module, config: LoRAConfig) -> tuple:
    """(trainable parameter count, f32 checkpoint bytes) of an adapter for
    ``model``; a model built on the ``meta`` device will do."""
    shapes = _shapes(model)
    n = sum(shapes[p][0] * config.rank + config.rank * shapes[p][1]
            for p in target_paths(model, config))
    return n, n * 4


def adapter_spec(adapter: dict) -> dict:
    """Shapes of every module's leaves: what bank registration and
    checkpoints validate against."""
    return {p: {k: tuple(torch.as_tensor(adapter[p][k]).shape) for k in ADAPTER_LEAVES}
            for p in adapter_module_paths(adapter)}
