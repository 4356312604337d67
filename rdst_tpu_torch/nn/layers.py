"""Shared layers (counterpart of ``rdst_tpu/nn/layers.py``).

* LayerNorm uses eps=1e-5 (the torch default, as in the JAX package).
* GELU is exact (erf).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with the torch-default epsilon."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (inference: dropout rates are 0)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))
