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

from rdst_tpu_torch.nn.layers import activation, constant_buffer

BF16 = torch.bfloat16


def flax_bf16(conv, x: torch.Tensor, weight: torch.Tensor, bias,
              **kw) -> torch.Tensor:
    """A flax convolution at ``dtype=bfloat16`` on a channels-first
    tensor: ``conv`` (``F.conv2d``, ``F.conv3d``, ``F.conv_transpose2d``)
    of the bf16-rounded operands in float32, rounded to bf16, then the bf16
    bias added and rounded."""
    y = conv(x.to(BF16).float(), weight.to(BF16).float(), None, **kw).to(BF16)
    if bias is not None:
        shape = (-1,) + (1,) * (y.dim() - 2)
        y = (y.float() + bias.to(BF16).float().view(shape)).to(BF16)
    return y


class Conv(nn.Conv2d):
    """Conv with bias on NHWC tensors, same-padding unless ``padding`` is
    given; weight is OIHW (``groups`` > 1: a grouped or depthwise conv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, bias: bool = True,
                 padding=None, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride,
                         padding=kernel_size // 2 if padding is None
                         else padding, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            return flax_bf16(F.conv2d, x.permute(0, 3, 1, 2), self.weight,
                             self.bias, stride=self.stride,
                             padding=self.padding,
                             groups=self.groups).permute(0, 2, 3, 1)
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``ConvTranspose(k, s, 'VALID')`` cropped by ``padding`` on each
    side, which is torch's ``ConvTranspose2d(k, s, padding)``, on NHWC
    tensors. The weight is torch's (in, out, kh, kw): the flax kernel
    (kh, kw, in, out) flipped in both spatial axes
    (``checkpoint.convert``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if x.dtype == BF16:
            y = flax_bf16(F.conv_transpose2d, x, self.weight, self.bias,
                          stride=self.stride, padding=self.padding)
        else:
            y = F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                   self.padding)
        return y.permute(0, 2, 3, 1)


def norm_buffers(module: nn.Module, mean: Sequence[float],
                 std: Sequence[float]) -> None:
    """A model's normalization: ``module.mean`` / ``module.std`` as tuples
    and as the buffers ``norm_mean`` / ``norm_std`` that
    :func:`mean_shift` takes (:func:`constant_buffer`)."""
    module.mean, module.std = tuple(mean), tuple(std)
    constant_buffer(module, "norm_mean", module.mean)
    constant_buffer(module, "norm_std", module.std)


def mean_shift(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
               mode: str) -> torch.Tensor:
    """Elementwise (x - mean)/std ('sub') or x*std + mean ('add'), in
    x's dtype (bf16: mean and std rounded, each op's result rounded).
    ``mean`` / ``std``: tensors on x's device, a model's float64 buffers
    (:func:`norm_buffers`)."""
    mean, std = mean.to(x.dtype), std.to(x.dtype)
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
        norm_buffers(self, mean, std)
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
            return mean_shift(x, self.norm_mean, self.norm_std,
                              self.mode)
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


class DenseLayer(nn.Module):
    """conv + activation, then the input and ``y * dense_scale`` side by
    side on the channels (``rdst_tpu/nn/common.py::DenseLayer``; the conv
    keeps the flax name ``conv``)."""

    def __init__(self, in_channels: int, growth_rate: int,
                 kernel_size: int = 3, act: str = "relu",
                 dense_scale: float = 1.0):
        super().__init__()
        self.conv = Conv(in_channels, growth_rate, kernel_size)
        self.act = activation(act)
        self.dense_scale = float(dense_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.conv(x))
        return torch.cat([x, y * self.dense_scale], dim=-1)


class ResidualDenseBlock(nn.Module):
    """``n_dense_layers`` dense layers (``dense_i``), a 1x1 ``bottleneck``
    back to the input's width, then ``x + y * res_scale``."""

    def __init__(self, in_channels: int, growth_rate: int,
                 n_dense_layers: int = 8, kernel_size: int = 3,
                 act: str = "relu", dense_scale: float = 1.0,
                 res_scale: float = 1.0):
        super().__init__()
        self.n_dense_layers = int(n_dense_layers)
        for i in range(self.n_dense_layers):
            self.add_module(f"dense_{i}", DenseLayer(
                in_channels + i * growth_rate, growth_rate, kernel_size, act,
                dense_scale))
        self.bottleneck = Conv(in_channels + self.n_dense_layers
                               * growth_rate, in_channels, 1)
        self.res_scale = float(res_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_dense_layers):
            y = getattr(self, f"dense_{i}")(y)
        return x + self.bottleneck(y) * self.res_scale
