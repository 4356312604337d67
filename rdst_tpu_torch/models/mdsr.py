"""MDSR multi-scale baseline (counterpart of ``rdst_tpu/models/mdsr.py``).

Per-scale heads (``head_{s}``) and tails (``tail_up_{s}``,
``tail_conv_{s}``) around one EDSR-style body; the call's scale picks the
branch. Flax creates a branch when it is first called, and the JAX
trainer's init calls every training scale, so a JAX snapshot holds the
branches of ``all_sr_scales``: the port builds exactly those (``scales``),
so that a snapshot loads strictly. MetaSR's ``Meta_MDSR`` extractor
(``feature_maps_only``) holds the heads of ``ceil(s)`` over its training
scales.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (Conv, ResBlock, UpSampler, mean_shift,
                                      norm_buffers)
from rdst_tpu_torch.nn.layers import resolve_act

MDSR_SCALES = (2, 3, 4)


def mdsr_scale(sr_scale) -> int:
    """The branch of ``sr_scale``: 2, 3 or 4, checked before it is made an
    integer (2.5 raises instead of taking branch 2)."""
    if sr_scale is None or float(sr_scale) not in MDSR_SCALES:
        raise ValueError(f"Invalid sr_scale {sr_scale}, should be 2/3/4")
    return int(float(sr_scale))


class MDSR(NoKernels, nn.Module):
    """``forward(x, sr_scale)`` on NHWC tensors; the scale is required and
    must be one of ``scales``."""

    def __init__(self, scales: Sequence[int], in_chans: int = 1,
                 n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, act: str = "leaky_relu",
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 feature_maps_only: bool = False,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.scales = tuple(sorted({mdsr_scale(s) for s in scales}))
        self.out_feats, self.n_resblocks = int(n_feats), int(n_resblocks)
        norm_buffers(self, mean, std)
        self.feature_maps_only = bool(feature_maps_only)
        for s in self.scales:
            self.add_module(f"head_{s}", Conv(in_chans, n_feats, 3))
        for i in range(self.n_resblocks):
            self.add_module(f"body_{i}", ResBlock(n_feats, 3, act, res_scale))
        self.body_conv = Conv(n_feats, n_feats, 3)
        if self.feature_maps_only:
            return
        for s in self.scales:
            self.add_module(f"tail_up_{s}", UpSampler(s, n_feats))
            self.add_module(f"tail_conv_{s}", Conv(n_feats, in_chans, 3))

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        s = mdsr_scale(sr_scale)
        if s not in self.scales:
            raise ValueError(f"MDSR has branches for scales {self.scales} "
                             f"(its training scales), not {s}")
        x = x.to(self.dtype)
        if not self.feature_maps_only:
            x = mean_shift(x, self.norm_mean, self.norm_std, "sub")
        x = getattr(self, f"head_{s}")(x)
        res = x
        for i in range(self.n_resblocks):
            res = getattr(self, f"body_{i}")(res)
        res = self.body_conv(res) + x
        if self.feature_maps_only:
            return res
        out = getattr(self, f"tail_up_{s}")(res)
        out = getattr(self, f"tail_conv_{s}")(out)
        return mean_shift(out, self.norm_mean, self.norm_std, "add")


def make_mdsr(paras, mean=None, std=None, dtype=torch.float32,
              feature_maps_only: bool = False) -> MDSR:
    """Factory keyed off the reference config names (``mdsr_*``): the
    branches of ``all_sr_scales``, or for MetaSR's extractor
    (``feature_maps_only``) of their ceilings."""
    c = paras.input_channel
    scales = [float(s) for s in paras.all_sr_scales]
    if feature_maps_only:
        scales = [math.ceil(s) for s in scales]
    return MDSR(
        scales, in_chans=c,
        n_feats=paras.get("mdsr_n_feats", 64),
        n_resblocks=paras.get("mdsr_n_resblocks", 16),
        res_scale=paras.get("mdsr_res_scale", 1.0),
        act=resolve_act(paras, paras.get("mdsr_act", "leaky_relu")),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        feature_maps_only=feature_maps_only, dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
