"""A seeded regression problem and a small MLP to train on it.

Counterpart of ``accelerate_tpu/test_utils/training.py``: ``RegressionData``
is the same data (numpy, same seed); ``init_mlp`` draws its weights from
numpy here (the JAX package's from ``jax.random``), so a parity test hands
both packages one set of weights. ``RegressionModel`` holds the weights as
parameters named ``w1``, ``b1``, ``w2``, ``b2``, the names ``mse_loss``
reads from the parameters an ``Accelerator`` passes to a loss function.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def RegressionData(n: int = 64, seed: int = 0):
    """``n`` samples ``{"x": [4], "y": [1]}`` of a fixed linear map plus
    noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = np.array([[1.0], [-2.0], [0.5], [3.0]], dtype=np.float32)
    y = x @ w + 0.1 * rng.normal(size=(n, 1)).astype(np.float32)
    return [{"x": x[i], "y": y[i]} for i in range(n)]


def init_mlp(seed: int = 0, din: int = 4, dh: int = 16, dout: int = 1) -> dict:
    """MLP weights as float32 numpy arrays: normal * 0.3, zero biases."""
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(din, dh)) * 0.3).astype(np.float32),
            "b1": np.zeros((dh,), np.float32),
            "w2": (rng.normal(size=(dh, dout)) * 0.3).astype(np.float32),
            "b2": np.zeros((dout,), np.float32)}


class RegressionModel(nn.Module):
    """The MLP as a module, from :func:`init_mlp`'s weights (or a seed)."""

    def __init__(self, params: dict | None = None, seed: int = 0):
        super().__init__()
        params = init_mlp(seed) if params is None else params
        for name, value in params.items():
            setattr(self, name, nn.Parameter(torch.as_tensor(np.asarray(value)).clone()))

    def forward(self, x):
        return mlp_apply(dict(self.named_parameters()), x)


def mlp_apply(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mse_loss(params, batch):
    pred = mlp_apply(params, batch["x"])
    return torch.mean((pred - batch["y"]) ** 2)
