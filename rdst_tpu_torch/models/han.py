"""HAN baseline (counterpart of ``rdst_tpu/models/han.py``).

RCAN-style residual groups of plain-conv channel-attention blocks, then
holistic attention: LAM (layer attention over the group outputs stacked
newest first, the body conv's output prepended last) and CSAM (a 1 -> 1
3x3x3 ``Conv3d`` gate over (B, 1, C, H, W), the channels as depth), fused
by two 3x3 convs before the global residual. The JAX factory hard-codes
10 groups x 20 blocks x 128 feats.

In bfloat16 the float32 ``gamma`` of LAM and CSAM makes their outputs
float32, as JAX's type promotion does; the convs after them round their
input to bf16, as a flax conv at ``dtype=bfloat16`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.models.rcan import CALayer, ResidualGroup
from rdst_tpu_torch.nn.common import (BF16, Conv, UpSampler, flax_bf16,
                                      mean_shift, norm_buffers)


class HanRCAB(nn.Module):
    """conv, ReLU, conv, channel attention, residual."""

    def __init__(self, n_feat: int, reduction: int = 16):
        super().__init__()
        self.conv_0 = Conv(n_feat, n_feat, 3)
        self.conv_1 = Conv(n_feat, n_feat, 3)
        self.ca = CALayer(n_feat, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ca(self.conv_1(F.relu(self.conv_0(x))))


def _bf16_op(fn, *xs):
    """``fn`` of bf16 tensors computed in float32, rounded to bf16."""
    return fn(*(x.float() for x in xs)).to(BF16)


class LAM(nn.Module):
    """Layer attention: x (B, N, H, W, C) -> softmax(rowmax(E) - E) of the
    Gram matrix E of the N flattened maps, times the maps, scaled by
    ``gamma`` (0 at init) plus x, flattened layer-major to (B, H, W,
    N*C)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, h, w, c = x.shape
        flat = x.reshape(b, n, -1)
        if x.dtype == BF16:
            energy = _bf16_op(lambda f: f @ f.transpose(1, 2), flat)
            energy = _bf16_op(lambda e: e.amax(-1, keepdim=True) - e, energy)
            attn = _bf16_op(lambda e: torch.softmax(e, -1), energy)
            out = _bf16_op(torch.matmul, attn, flat)
        else:
            energy = flat @ flat.transpose(1, 2)
            attn = torch.softmax(energy.amax(-1, keepdim=True) - energy, -1)
            out = attn @ flat
        out = self.gamma * out.reshape(x.shape) + x
        return out.permute(0, 2, 3, 1, 4).reshape(b, h, w, n * c)


class CSAM(nn.Module):
    """Channel-spatial attention: ``x * (gamma * sigmoid(conv3d(v))) + x``
    with v = x as (B, 1, C, H, W); ``gamma`` 0 at init."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.conv3d = nn.Conv3d(1, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        vol = x.permute(0, 3, 1, 2).unsqueeze(1)
        if x.dtype == BF16:
            gate = flax_bf16(F.conv3d, vol, self.conv3d.weight,
                             self.conv3d.bias, padding=1)
            gate = _bf16_op(torch.sigmoid, gate)
        else:
            gate = torch.sigmoid(self.conv3d(vol))
        gate = gate[:, 0].permute(0, 2, 3, 1)
        return x * (self.gamma * gate) + x


class HAN(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_resgroups: int = 10, n_resblocks: int = 20,
                 n_feats: int = 128, reduction: int = 16,
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.n_resgroups = int(n_resgroups)
        norm_buffers(self, mean, std)
        self.head = Conv(in_chans, n_feats, 3)
        for i in range(self.n_resgroups):
            self.add_module(f"body_{i}", ResidualGroup(
                n_feats, n_resblocks, reduction, block=HanRCAB))
        self.body_conv = Conv(n_feats, n_feats, 3)
        self.la = LAM()
        self.last_conv = Conv(n_feats * (self.n_resgroups + 1), n_feats, 3)
        self.csa = CSAM()
        self.last = Conv(2 * n_feats, n_feats, 3)
        self.tail_up = UpSampler(int(sr_scale), n_feats)
        self.tail_conv = Conv(n_feats, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        x = self.head(mean_shift(x.to(self.dtype), self.norm_mean,
                                 self.norm_std, "sub"))
        res, stacked = x, []
        for i in range(self.n_resgroups):
            res = getattr(self, f"body_{i}")(res)
            stacked.insert(0, res)  # newest first
        res = self.body_conv(res)
        stacked.insert(0, res)
        out2 = self.last_conv(self.la(torch.stack(stacked, 1)).to(self.dtype))
        out1 = self.csa(res)
        fused = self.last(torch.cat([out1, out2.to(out1.dtype)], -1)
                          .to(self.dtype)) + x
        out = self.tail_conv(self.tail_up(fused))
        return mean_shift(out, self.norm_mean, self.norm_std, "add")


def make_han(paras, mean=None, std=None, dtype=torch.float32) -> HAN:
    """Factory: the JAX factory's hard-coded widths."""
    c = paras.input_channel
    return HAN(
        in_chans=c, sr_scale=int(paras.sr_scale),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        dtype=dtype, train_resolution=(paras.patch_size,) * 2,
    ).eval()
