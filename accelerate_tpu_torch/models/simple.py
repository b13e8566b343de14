"""Tiny deterministic models for tests and examples.

Counterpart of ``accelerate_tpu/models/simple.py``: ``RegressionModel``
(``y = a * x + b``, both scalars starting at zero) and ``MLP`` (ReLU dense
layers ``dense_<i>`` and an output layer ``out``, the flax names).
``test_utils/training.py`` keeps its own ``RegressionModel``: a tanh MLP
over ``init_mlp``'s weights, which computes another function, as the JAX
package's ``test_utils`` does beside this one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


class RegressionModel(nn.Module):
    """y = a*x + b, with ``a`` and ``b`` scalars initialised to zero."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.a = nn.Parameter(torch.zeros((), device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros((), device=device, dtype=dtype))

    def forward(self, x):
        return self.a * x + self.b


class MLP(nn.Module):
    """ReLU layers of ``features`` widths, then ``num_outputs`` linear
    outputs. ``generator`` draws the weights: kernels N(0, 1 / fan_in),
    biases zero."""

    def __init__(self, input_dim: int, features: tuple = (64, 64), num_outputs: int = 1,
                 device=None, dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.features = tuple(features)
        self.num_outputs = num_outputs
        widths = (input_dim,) + self.features
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"dense_{i}", nn.Linear(n_in, n_out, device=device, dtype=dtype))
        self.out = nn.Linear(widths[-1], num_outputs, device=device, dtype=dtype)
        if generator is not None:
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if name.endswith("bias"):
                        p.zero_()
                    else:
                        p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)

    def forward(self, x):
        for i in range(len(self.features)):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.out(x)
