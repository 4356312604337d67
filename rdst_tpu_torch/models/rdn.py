"""RDN baseline (counterpart of ``rdst_tpu/models/rdn.py``).

head -> F0 conv -> N residual dense blocks -> every block's output side by
side -> 1x1 + 3x3 bottleneck (``bottleneck.0`` / ``.1``, flax
``bottleneck_0`` / ``_1``) -> scaled global residual -> PixelShuffle tail.
The activation is the config's ``act`` as it is: the JAX factory does not
pass it through ``resolve_act``, so ``leaky_relu_slope`` does not reach
RDN.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (Conv, ResidualDenseBlock, UpSampler,
                                      mean_shift, norm_buffers)


class RDN(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read. ``feature_maps_only``: MetaSR's extractor (no mean shift, no
    tail)."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_feats: int = 64, growth_rate: int = 32,
                 n_dense_layers: int = 6, n_blocks: int = 20,
                 dense_scale: float = 1.0, local_res_scale: float = 1.0,
                 global_res_scale: float = 1.0, act: str = "leaky_relu",
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 feature_maps_only: bool = False,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.sr_scale, self.out_feats = int(sr_scale), int(n_feats)
        self.n_blocks = int(n_blocks)
        self.global_res_scale = float(global_res_scale)
        norm_buffers(self, mean, std)
        self.feature_maps_only = bool(feature_maps_only)
        self.head = Conv(in_chans, n_feats, 3)
        self.F0 = Conv(n_feats, n_feats, 3)
        for i in range(self.n_blocks):
            self.add_module(f"body_{i}", ResidualDenseBlock(
                n_feats, growth_rate, n_dense_layers, 3, act, dense_scale,
                local_res_scale))
        self.bottleneck = nn.Sequential(
            Conv(self.n_blocks * n_feats, n_feats, 1),
            Conv(n_feats, n_feats, 3))
        if self.feature_maps_only:
            return
        if self.sr_scale > 1:
            self.tail_up = UpSampler(self.sr_scale, n_feats)
        self.tail_conv = Conv(n_feats, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.feature_maps_only:
            x = mean_shift(x, self.norm_mean, self.norm_std, "sub")
        fn1 = self.head(x)
        x = self.F0(fn1)
        maps = []
        for i in range(self.n_blocks):
            x = getattr(self, f"body_{i}")(x)
            maps.append(x)
        x = self.bottleneck(torch.cat(maps, dim=-1))
        x = x * self.global_res_scale + fn1
        if self.feature_maps_only:
            return x
        if self.sr_scale > 1:
            x = self.tail_up(x)
        return mean_shift(self.tail_conv(x), self.norm_mean,
                          self.norm_std, "add")


def make_rdn(paras, mean=None, std=None, dtype=torch.float32,
             feature_maps_only: bool = False) -> RDN:
    """Factory keyed off the reference config names (``rdn_*``, ``act``)."""
    c = paras.input_channel
    return RDN(
        in_chans=c, sr_scale=int(paras.sr_scale),
        n_feats=paras.get("rdn_n_feats", 64),
        growth_rate=paras.get("rdn_growth_rate", 32),
        n_dense_layers=paras.get("rdn_n_dense_layers", 6),
        n_blocks=paras.get("rdn_n_blocks", 20),
        dense_scale=paras.get("rdn_dense_scale", 1.0),
        local_res_scale=paras.get("rdn_local_res_scale", 1.0),
        global_res_scale=paras.get("rdn_global_res_scale", 1.0),
        act=paras.get("act", "leaky_relu"),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        feature_maps_only=feature_maps_only, dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
