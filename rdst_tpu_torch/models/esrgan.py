"""ESRGAN generator (counterpart of ``rdst_tpu/models/esrgan.py``).

Residual-in-residual dense blocks (``n_rdb`` RDBs an RRDB, residual scales
0.2 at both levels by default), the body conv, the scaled global
residual, the PixelShuffle tail.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (Conv, ResidualDenseBlock, UpSampler,
                                      mean_shift, norm_buffers)
from rdst_tpu_torch.nn.layers import resolve_act


class RRDB(nn.Module):
    """``n_rdb`` residual dense blocks (``rdb_i``), then
    ``x + y * rrdb_res_scale``."""

    def __init__(self, n_feats: int, growth_rate: int,
                 n_dense_layers: int = 4, n_rdb: int = 3,
                 act: str = "leaky_relu", dense_scale: float = 1.0,
                 rdb_res_scale: float = 0.2, rrdb_res_scale: float = 0.2):
        super().__init__()
        self.n_rdb = int(n_rdb)
        for i in range(self.n_rdb):
            self.add_module(f"rdb_{i}", ResidualDenseBlock(
                n_feats, growth_rate, n_dense_layers, 3, act, dense_scale,
                rdb_res_scale))
        self.rrdb_res_scale = float(rrdb_res_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_rdb):
            y = getattr(self, f"rdb_{i}")(y)
        return x + y * self.rrdb_res_scale


class ESRGAN(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read. ``feature_maps_only``: MetaSR's extractor."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_feats: int = 64, growth_rate: int = 32,
                 n_dense_layers: int = 4, n_rdb: int = 3, n_blocks: int = 8,
                 dense_scale: float = 1.0, rdb_res_scale: float = 0.2,
                 rrdb_res_scale: float = 0.2, global_res_scale: float = 1.0,
                 act: str = "leaky_relu", mean: Sequence[float] = (0.0,),
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
        for i in range(self.n_blocks):
            self.add_module(f"body_{i}", RRDB(
                n_feats, growth_rate, n_dense_layers, n_rdb, act,
                dense_scale, rdb_res_scale, rrdb_res_scale))
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
        for i in range(self.n_blocks):
            res = getattr(self, f"body_{i}")(res)
        res = self.body_conv(res) * self.global_res_scale + x
        if self.feature_maps_only:
            return res
        out = self.tail_up(res) if self.sr_scale > 1 else res
        return mean_shift(self.tail_conv(out), self.norm_mean,
                          self.norm_std, "add")


def make_esrgan(paras, mean=None, std=None, dtype=torch.float32,
                feature_maps_only: bool = False) -> ESRGAN:
    """Factory keyed off the reference config names (``esrgan_*``)."""
    c = paras.input_channel
    return ESRGAN(
        in_chans=c, sr_scale=int(paras.sr_scale),
        n_feats=paras.get("esrgan_n_feats", 64),
        growth_rate=paras.get("esrgan_growth_rate", 32),
        n_dense_layers=paras.get("esrgan_n_dense_layers", 4),
        n_rdb=paras.get("esrgan_n_rdb", 3),
        n_blocks=paras.get("esrgan_n_blocks", 8),
        dense_scale=paras.get("esrgan_dense_scale", 1.0),
        rdb_res_scale=paras.get("esrgan_rdb_res_scale", 0.2),
        rrdb_res_scale=paras.get("esrgan_rrdb_res_scale", 0.2),
        global_res_scale=paras.get("esrgan_global_res_scale", 1.0),
        act=resolve_act(paras, paras.get("esrgan_act", "leaky_relu")),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        feature_maps_only=feature_maps_only, dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
