"""RCAN baseline (counterpart of ``rdst_tpu/models/rcan.py``).

Residual groups of channel-attention blocks whose convs are the
reference's ``Ada_conv``: a hard 0/1 gate from a sigmoid of a 1x1 conv
over a spatially transposed read of x blends two 3x3 convs. The gate
carries no gradient (the JAX package's ``stop_gradient``): it is computed
under ``torch.no_grad()``. The JAX factory hard-codes 10 groups x 20
blocks x 64 feats, reduction 16.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (BF16, Conv, UpSampler, mean_shift,
                                      norm_buffers)


class CALayer(nn.Module):
    """Squeeze-excite channel attention: the spatial mean, 1x1 conv down
    by ``reduction`` (``du_0``), ReLU, 1x1 conv back (``du_1``), sigmoid
    gate on x."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.du_0 = Conv(channel, channel // reduction, 1)
        self.du_1 = Conv(channel // reduction, channel, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:  # jnp.mean of bf16: f32 sums, a bf16 result
            y = x.float().mean(dim=(1, 2), keepdim=True).to(BF16)
        else:
            y = x.mean(dim=(1, 2), keepdim=True)
        y = self.du_1(F.relu(self.du_0(y)))
        return x * torch.sigmoid(y)


class AdaConv(nn.Module):
    """Hard-gated dual conv: mask = 1 where sigmoid(conv0(xt)) < 0.5 (the
    reference's inverted convention), out = conv1(x) * mask + conv2(x) *
    (1 - mask). ``xt`` is the NHWC x transposed to (B, W, H, C) and read
    back as (B, H, W, C): for H != W a reinterpretation of the memory, as
    the reference's ``permute(0, 1, 3, 2).contiguous().view`` is."""

    def __init__(self, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv0 = Conv(features, features, 1)
        self.conv1 = Conv(features, features, kernel_size)
        self.conv2 = Conv(features, features, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        with torch.no_grad():
            xt = x.transpose(1, 2).reshape(b, h, w, c)
            mask = (torch.sigmoid(self.conv0(xt)) < 0.5).to(x.dtype)
        return self.conv1(x) * mask + self.conv2(x) * (1.0 - mask)


class RCAB(nn.Module):
    """AdaConv, ReLU, AdaConv, channel attention, residual."""

    def __init__(self, n_feat: int, reduction: int = 16):
        super().__init__()
        self.conv_0 = AdaConv(n_feat, 3)
        self.conv_1 = AdaConv(n_feat, 3)
        self.ca = CALayer(n_feat, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ca(self.conv_1(F.relu(self.conv_0(x))))


class ResidualGroup(nn.Module):
    """``n_resblocks`` blocks (``rcab_i``), a 3x3 ``conv``, residual."""

    def __init__(self, n_feat: int, n_resblocks: int, reduction: int = 16,
                 block=RCAB):
        super().__init__()
        self.n_resblocks = int(n_resblocks)
        for i in range(self.n_resblocks):
            self.add_module(f"rcab_{i}", block(n_feat, reduction))
        self.conv = Conv(n_feat, n_feat, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_resblocks):
            y = getattr(self, f"rcab_{i}")(y)
        return x + self.conv(y)


class RCAN(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_resgroups: int = 10, n_resblocks: int = 20,
                 n_feats: int = 64, reduction: int = 16,
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.n_resgroups = int(n_resgroups)
        norm_buffers(self, mean, std)
        self.head = Conv(in_chans, n_feats, 3)
        for i in range(self.n_resgroups):
            self.add_module(f"body_{i}", ResidualGroup(n_feats, n_resblocks,
                                                       reduction))
        self.body_conv = Conv(n_feats, n_feats, 3)
        self.tail_up = UpSampler(int(sr_scale), n_feats)
        self.tail_conv = Conv(n_feats, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        x = self.head(mean_shift(x.to(self.dtype), self.norm_mean,
                                 self.norm_std, "sub"))
        res = x
        for i in range(self.n_resgroups):
            res = getattr(self, f"body_{i}")(res)
        res = self.body_conv(res) + x
        out = self.tail_conv(self.tail_up(res))
        return mean_shift(out, self.norm_mean, self.norm_std, "add")


def make_rcan(paras, mean=None, std=None, dtype=torch.float32) -> RCAN:
    """Factory: the JAX factory's hard-coded widths."""
    c = paras.input_channel
    return RCAN(
        in_chans=c, sr_scale=int(paras.sr_scale), n_resgroups=10,
        n_resblocks=20, n_feats=64, reduction=16,
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        dtype=dtype, train_resolution=(paras.patch_size,) * 2,
    ).eval()
