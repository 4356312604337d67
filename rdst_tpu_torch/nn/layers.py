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

Dropout and stochastic depth act in training mode only, drawing from an
explicit ``torch.Generator`` (:func:`set_generator`).
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


class Dropout(nn.Module):
    """``flax.linen.Dropout`` in training mode: each element kept with
    probability 1 - rate and scaled by 1 / keep; the identity in eval
    mode or at rate 0. Draws from ``generator`` (an explicit
    ``torch.Generator`` on the tensors' device, :func:`set_generator`),
    else from torch's default generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def _keep(self, shape, x):
        keep = 1.0 - self.rate
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return u < keep, keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        mask, keep = self._keep(x.shape, x)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(Dropout):
    """Stochastic depth (``rdst_tpu/nn/layers.py:60``): the whole branch
    of each sample (leading dim) kept with probability 1 - rate, scaled
    by 1 / keep."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        mask, keep = self._keep((x.shape[0],) + (1,) * (x.dim() - 1), x)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Give every stochastic layer under ``module`` (dropout, drop path,
    the pair route's factor columns) the explicit ``generator``."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features or in_features)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(gelu_exact(self.fc1(x)))))


def activation(name: Optional[str], slope: float = 0.2):
    """``rdst_tpu.nn.layers.activation``: None/'none' the identity, 'relu',
    'leaky_relu' (or 'leaky_relu:<slope>'), 'prelu' as a fixed 0.25 slope,
    'gelu' exact."""
    if name in (None, "none", "None"):
        return lambda x: x
    if name == "relu":
        return F.relu
    if isinstance(name, str) and name.startswith("leaky_relu"):
        if ":" in name:
            slope = float(name.split(":", 1)[1])
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if name == "prelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.25)
    if name == "gelu":
        return gelu_exact
    raise ValueError(f"unknown activation: {name}")


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channels of an NCHW tensor.

    ``forward(x, train)``: with ``train`` the batch statistics normalize
    (mean and the fast variance ``max(E[x^2] - E[x]^2, 0)`` over N, H, W,
    in float32) and the running statistics move as flax moves them,
    ``r = momentum * r + (1 - momentum) * batch`` with the *biased*
    variance (flax's ``momentum=0.9`` is torch's 0.1); without it the
    running statistics normalize. The running statistics are buffers
    updated in place and carry no gradient. State-dict keys: ``weight``
    (flax ``scale``), ``bias``, ``running_mean`` (``mean``),
    ``running_var`` (``var``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = float(eps), float(momentum)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])
