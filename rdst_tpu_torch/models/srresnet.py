"""SRResNet baseline (counterpart of ``rdst_tpu/models/srresnet.py``).

head conv -> n ResBlocks -> conv -> global residual -> PixelShuffle tail;
with ``feature_maps_only`` the mean shift and the tail are skipped
(MetaSR's extractor). 'prelu' is the fixed 0.25 slope of both packages
(no parameter). Module names are the flax names with each ``Conv``'s
inner ``conv`` level dropped (``checkpoint.convert.export_named``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (Conv, ResBlock, UpSampler, mean_shift,
                                      norm_buffers)
from rdst_tpu_torch.nn.layers import resolve_act


class SRResNet(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, act: str = "prelu",
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 feature_maps_only: bool = False,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.sr_scale, self.out_feats = int(sr_scale), int(n_feats)
        self.n_resblocks = int(n_resblocks)
        norm_buffers(self, mean, std)
        self.feature_maps_only = bool(feature_maps_only)
        self.head = Conv(in_chans, n_feats, 3)
        for i in range(self.n_resblocks):
            self.add_module(f"body_{i}", ResBlock(n_feats, 3, act, res_scale))
        self.body_conv = Conv(n_feats, n_feats, 3)
        if self.feature_maps_only:
            return
        if self.sr_scale > 1:
            self.tail_up = UpSampler(self.sr_scale, n_feats)
        self.tail_conv = Conv(n_feats, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.feature_maps_only:
            x = mean_shift(x, self.norm_mean, self.norm_std, "sub")
        x = self.head(x)
        res = x
        for i in range(self.n_resblocks):
            res = getattr(self, f"body_{i}")(res)
        res = self.body_conv(res) + x
        if self.feature_maps_only:
            return res
        out = self.tail_up(res) if self.sr_scale > 1 else res
        return mean_shift(self.tail_conv(out), self.norm_mean,
                          self.norm_std, "add")


def make_srresnet(paras, mean=None, std=None, dtype=torch.float32,
                  feature_maps_only: bool = False) -> SRResNet:
    """Factory keyed off the reference config names (``srresnet_*``)."""
    c = paras.input_channel
    return SRResNet(
        in_chans=c, sr_scale=int(paras.sr_scale),
        n_feats=paras.get("srresnet_n_feats", 64),
        n_resblocks=paras.get("srresnet_n_resblocks", 16),
        res_scale=paras.get("srresnet_res_scale", 1.0),
        act=resolve_act(paras, paras.get("srresnet_act", "prelu")),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        feature_maps_only=feature_maps_only, dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
