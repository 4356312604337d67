"""SRDenseNet baseline (counterpart of ``rdst_tpu/models/srdensenet.py``).

Dense blocks of dense layers; the maps a skip type collects ('h': the last
block's, 'hl': the head's and the last block's, 'all': the head's and every
block's) side by side into a 1x1 ``bottleneck`` to ``n_feats``, then the
PixelShuffle tail.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (Conv, DenseLayer, UpSampler, mean_shift,
                                      norm_buffers)
from rdst_tpu_torch.nn.layers import resolve_act

SKIP_TYPES = ("h", "hl", "all")


class DenseBlock(nn.Sequential):
    """``n_dense_layers`` dense layers named ``dense_i``."""

    def __init__(self, in_channels: int, growth_rate: int,
                 n_dense_layers: int = 8, act: str = "relu",
                 dense_scale: float = 1.0):
        super().__init__()
        for i in range(int(n_dense_layers)):
            self.add_module(f"dense_{i}", DenseLayer(
                in_channels + i * growth_rate, growth_rate, 3, act,
                dense_scale))


class SRDenseNet(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read. ``feature_maps_only``: MetaSR's extractor (the bottleneck's
    ``n_feats`` maps, no mean shift, no tail)."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 growth_rate: int = 16, n_dense_layers: int = 8,
                 n_dense_blocks: int = 8, skip_type: str = "all",
                 dense_scale: float = 1.0, n_feats: int = 256,
                 act: str = "relu", mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 feature_maps_only: bool = False,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        if skip_type not in SKIP_TYPES:
            raise ValueError(f"srdensenet_type {skip_type!r}: one of "
                             f"{SKIP_TYPES}")
        self._no_kernels(dtype, train_resolution)
        self.sr_scale, self.out_feats = int(sr_scale), int(n_feats)
        self.skip_type = skip_type
        self.n_dense_blocks = int(n_dense_blocks)
        norm_buffers(self, mean, std)
        self.feature_maps_only = bool(feature_maps_only)
        self.head = Conv(in_chans, growth_rate, 3)
        step = n_dense_layers * growth_rate  # the width a block adds
        for i in range(self.n_dense_blocks):
            self.add_module(f"body_{i}", DenseBlock(
                growth_rate + i * step, growth_rate, n_dense_layers, act,
                dense_scale))
        last = growth_rate + self.n_dense_blocks * step
        collected = {"h": last, "hl": growth_rate + last,
                     "all": sum(growth_rate + i * step
                                for i in range(self.n_dense_blocks + 1))}
        self.bottleneck = Conv(collected[skip_type], n_feats, 1)
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
        collected = [x] if self.skip_type in ("hl", "all") else []
        for i in range(self.n_dense_blocks):
            x = getattr(self, f"body_{i}")(x)
            if self.skip_type == "all":
                collected.append(x)
        if self.skip_type in ("h", "hl"):
            collected.append(x)
        x = self.bottleneck(torch.cat(collected, dim=-1))
        if self.feature_maps_only:
            return x
        if self.sr_scale > 1:
            x = self.tail_up(x)
        return mean_shift(self.tail_conv(x), self.norm_mean,
                          self.norm_std, "add")


def make_srdensenet(paras, mean=None, std=None, dtype=torch.float32,
                    feature_maps_only: bool = False) -> SRDenseNet:
    """Factory keyed off the reference config names (``srdensenet_*``)."""
    c = paras.input_channel
    return SRDenseNet(
        in_chans=c, sr_scale=int(paras.sr_scale),
        growth_rate=paras.get("srdensenet_growth_rate", 16),
        n_dense_layers=paras.get("srdensenet_n_dense_layers", 8),
        n_dense_blocks=paras.get("srdensenet_n_dense_blocks", 8),
        skip_type=paras.get("srdensenet_type", "all"),
        dense_scale=paras.get("srdensenet_dense_scale", 1.0),
        n_feats=paras.get("srdensenet_n_feats", 256),
        act=resolve_act(paras, paras.get("srdensenet_act", "relu")),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        feature_maps_only=feature_maps_only, dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
