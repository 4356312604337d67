"""Conv-side building blocks (counterpart of ``rdst_tpu/nn/common.py``).

Public functions and modules take and return NHWC tensors, the JAX
package's layout; the convolutions themselves run as
``torch.nn.functional.conv2d`` (the JAX package left them to XLA, outside
any Pallas kernel). On bfloat16 activations they compute as the flax
modules do at ``dtype=bfloat16`` (``nn.layers``' policy): the conv of bf16
operands rounded to bf16, then the bf16 bias added and rounded.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.nn.layers import activation

BF16 = torch.bfloat16


class Conv(nn.Conv2d):
    """Same-padding conv with bias on NHWC tensors; weight is OIHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                         self.weight.to(BF16).float(), None, self.stride,
                         self.padding).to(BF16)
            if self.bias is not None:
                y = (y.float() + self.bias.to(BF16).float()[:, None, None]
                     ).to(BF16)
            return y.permute(0, 2, 3, 1)
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def mean_shift(x: torch.Tensor, mean: Sequence[float], std: Sequence[float],
               mode: str) -> torch.Tensor:
    """Elementwise (x - mean)/std ('sub') or x*std + mean ('add'), in
    x's dtype (bf16: mean and std rounded, each op's result rounded)."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    if mode == "sub":
        return (x - mean) / std
    if mode == "add":
        return x * std + mean
    raise ValueError("mode must be 'sub' or 'add'")


class MeanShift(nn.Module):
    """The reference's frozen 1x1-conv MeanShift, kept as parameters so
    the state_dict carries ``sub_mean``/``add_mean``. Forward applies
    the diagonal on NHWC: x * weight[c, c] + bias[c]."""

    def __init__(self, mean: Sequence[float], std: Sequence[float],
                 mode: str):
        super().__init__()
        self.mode = mode
        self.mean, self.std = tuple(mean), tuple(std)
        mean = torch.as_tensor(mean, dtype=torch.float32)
        std = torch.as_tensor(std, dtype=torch.float32)
        nc = mean.numel()
        scale, shift = ((1.0 / std, -mean / std) if mode == "sub"
                        else (std, mean.clone()))
        self.weight = nn.Parameter(torch.diag(scale).reshape(nc, nc, 1, 1),
                                   requires_grad=False)
        self.bias = nn.Parameter(shift, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:  # the JAX package's mean_shift in bf16
            return mean_shift(x, self.mean, self.std, self.mode)
        nc = self.bias.numel()
        return (x * torch.diagonal(self.weight.reshape(nc, nc))
                + self.bias)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel shuffle with torch's channel ordering:
    out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


class PixelShuffle(nn.Module):
    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.r)


class UpSampler(nn.Sequential):
    """conv(C->4C) + shuffle(2) per octave, or conv(C->9C) + shuffle(3).
    Convs sit at the even indices, as in the reference's Sequential."""

    def __init__(self, scale: int, n_feats: int):
        layers = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [Conv(n_feats, 4 * n_feats, 3), PixelShuffle(2)]
        elif scale == 3:
            layers += [Conv(n_feats, 9 * n_feats, 3), PixelShuffle(3)]
        else:
            raise NotImplementedError(f"SR scale {scale} is not valid.")
        super().__init__(*layers)


class ResBlock(nn.Module):
    """conv, activation, conv, then ``x + y * res_scale``
    (``rdst_tpu/nn/common.py::ResBlock``); the convs keep the flax names
    ``conv_0`` / ``conv_1``."""

    def __init__(self, n_feats: int, kernel_size: int = 3, act: str = "relu",
                 res_scale: float = 1.0):
        super().__init__()
        self.conv_0 = Conv(n_feats, n_feats, kernel_size)
        self.conv_1 = Conv(n_feats, n_feats, kernel_size)
        self.act = activation(act)
        self.res_scale = float(res_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_1(self.act(self.conv_0(x)))
        return x + y * self.res_scale
