"""Shared layers (counterpart of ``rdst_tpu/nn/layers.py``).

* LayerNorm uses eps=1e-5 (the torch default, as in the JAX package).
* GELU is exact (erf).

Compute-dtype policy. Parameters stay float32 masters, as the flax tree
does; a model built for bfloat16 inference feeds bfloat16 activations,
and each layer then computes as the JAX package's flax module does at
``dtype=bfloat16`` (operands cast to bf16 at use, every op's output
rounded to bf16): LayerNorm statistics in f32 by the fast variance
``max(E[x^2] - E[x]^2, 0)``, affine in f32, output bf16; a Dense layer's
product rounded to bf16, then its bf16 bias added and rounded again.
float32 activations take the float32 code unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

BF16 = torch.bfloat16


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == BF16:
        return F.gelu(x.float(), approximate="none").to(BF16)
    return F.gelu(x, approximate="none")


def linear_bf16(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``nn.Dense(dtype=bfloat16)``: bf16 operands, f32 products and sums,
    the product rounded to bf16, then the bf16 bias added and rounded.
    ``weight`` is (out, in)."""
    y = (x.float() @ weight.to(BF16).float().t()).to(BF16)
    if bias is not None:
        y = (y.float() + bias.to(BF16).float()).to(BF16)
    return y


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with the torch-default epsilon."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != BF16:
            return super().forward(x)
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                          min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(BF16)


class Linear(nn.Linear):
    """``nn.Linear`` that computes as a bf16 flax Dense on bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            return linear_bf16(x, self.weight, self.bias)
        return super().forward(x)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (inference: dropout rates are 0)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features or in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))
