"""EDSR baseline (counterpart of ``rdst_tpu/models/edsr.py``).

head conv -> n ResBlocks -> conv -> global residual -> PixelShuffle tail,
or the scale-free ``tail_meta`` (a ``MetaUpSampler``); with
``feature_maps_only`` the mean shift and the tail are skipped and the
body's features come out: MetaSR's extractor. Convolutions are
``F.conv2d`` (the JAX package leaves them to XLA). Module names are the
flax names, so that ``checkpoint.convert.export_named`` carries a flax
tree over (the ``conv`` level of each flax ``Conv`` dropped).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.meta_upscale import MetaUpSampler
from rdst_tpu_torch.nn.common import (Conv, ResBlock, UpSampler, mean_shift,
                                      norm_buffers)
from rdst_tpu_torch.nn.layers import BF16, resolve_act


class NoKernels:
    """The serving and training attributes of a model that runs no
    kernel of the port: the routes read as the plain path."""

    kernel_mode = ""
    softmax = ""
    quant = frozenset()
    train_mode = ""

    def route_units(self):
        return []

    def _no_kernels(self, dtype: torch.dtype, train_resolution) -> None:
        if dtype not in (torch.float32, BF16):
            raise NotImplementedError(
                f"{type(self).__name__} in {dtype}: the port computes in "
                "float32 or bfloat16")
        self.dtype = dtype
        self.routes = []
        self.train_routes = {"pair": 0, "block": 0}
        self.train_resolution = train_resolution


class EDSR(NoKernels, nn.Module):
    """EDSR on NHWC tensors: ``forward(x, sr_scale=None)``; the scale is
    read only by the scale-free tail, which needs it."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, act: str = "leaky_relu",
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,), scale_free: bool = False,
                 feature_maps_only: bool = False,
                 dtype: torch.dtype = torch.float32,
                 train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.sr_scale, self.out_feats = int(sr_scale), int(n_feats)
        self.n_resblocks = int(n_resblocks)
        norm_buffers(self, mean, std)
        self.scale_free = bool(scale_free)
        self.feature_maps_only = bool(feature_maps_only)
        self.head = Conv(in_chans, n_feats, 3)
        for i in range(self.n_resblocks):
            self.add_module(f"body_{i}",
                            ResBlock(n_feats, 3, act, res_scale))
        self.body_conv = Conv(n_feats, n_feats, 3)
        if self.feature_maps_only:
            return
        if self.scale_free:
            self.tail_meta = MetaUpSampler(n_feats, in_chans)
        else:
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
        if self.scale_free:
            out = self.tail_meta(res, sr_scale)
        else:
            out = self.tail_up(res) if self.sr_scale > 1 else res
            out = self.tail_conv(out)
        return mean_shift(out, self.norm_mean, self.norm_std, "add")


def make_edsr(paras, mean=None, std=None, dtype=torch.float32,
              feature_maps_only: bool = False) -> EDSR:
    """Factory keyed off the reference config names (``edsr_*``)."""
    c = paras.input_channel
    return EDSR(
        in_chans=c,
        sr_scale=int(paras.sr_scale),
        n_feats=paras.get("edsr_n_feats", 64),
        n_resblocks=paras.get("edsr_n_resblocks", 16),
        res_scale=paras.get("edsr_res_scale", 1.0),
        act=resolve_act(paras, paras.get("edsr_act", "leaky_relu")),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        scale_free=bool(paras.scale_free),
        feature_maps_only=feature_maps_only,
        dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
