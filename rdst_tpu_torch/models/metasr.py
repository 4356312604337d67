"""Meta-SR: a feature extractor + ``MetaUpSampler`` (counterpart of
``rdst_tpu/models/metasr.py``).

The extractor is one of the JAX package's six (``meta_feature_generator``:
EDSR, SRResNet, SRDenseNet, RDN, ESRGAN, Meta_MDSR) built with
``feature_maps_only``; the upsampler reads the extractor's output width
(``out_feats``: SRDenseNet's ``srdensenet_n_feats``, the others'
``*_n_feats``). ``Meta_MDSR`` is called at ``ceil(s)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.models.meta_upscale import MetaUpSampler, scale_value
from rdst_tpu_torch.nn.common import mean_shift, norm_buffers

EXTRACTORS = ("EDSR", "SRResNet", "SRDenseNet", "RDN", "ESRGAN", "Meta_MDSR")


def _make_extractor(paras, mode: str, dtype) -> nn.Module:
    if mode == "EDSR":
        from rdst_tpu_torch.models.edsr import make_edsr as make
    elif mode == "SRResNet":
        from rdst_tpu_torch.models.srresnet import make_srresnet as make
    elif mode == "SRDenseNet":
        from rdst_tpu_torch.models.srdensenet import make_srdensenet as make
    elif mode == "RDN":
        from rdst_tpu_torch.models.rdn import make_rdn as make
    elif mode == "ESRGAN":
        from rdst_tpu_torch.models.esrgan import make_esrgan as make
    elif mode == "Meta_MDSR":
        from rdst_tpu_torch.models.mdsr import make_mdsr as make
    else:
        raise ValueError(f"LR feature extractor {mode!r} should be one of "
                         f"[{', '.join(EXTRACTORS)}]")
    return make(paras, dtype=dtype, feature_maps_only=True)


class MetaSR(NoKernels, nn.Module):
    """``forward(x, sr_scale)``: NHWC LR -> (N, int(s*H), int(s*W), C).
    The scale is required: the JAX module's default of 2.0 is not
    copied, so no caller runs it at a scale it did not ask for."""

    def __init__(self, extractor: nn.Module, extractor_mode: str,
                 in_chans: int = 1, kernel_size: int = 3,
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        norm_buffers(self, mean, std)
        self.extractor_mode = extractor_mode
        self.extractor = extractor
        self.meta_upsampler = MetaUpSampler(extractor.out_feats, in_chans,
                                            kernel_size)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        scale = scale_value(sr_scale)
        x = mean_shift(x.to(self.dtype), self.norm_mean, self.norm_std, "sub")
        feats = self.extractor(x, math.ceil(scale)
                               if self.extractor_mode == "Meta_MDSR" else None)
        out = self.meta_upsampler(feats, scale)
        return mean_shift(out, self.norm_mean, self.norm_std, "add")


def make_metasr(paras, mean=None, std=None, dtype=torch.float32) -> MetaSR:
    """Factory: the extractor named by ``meta_feature_generator`` (else
    ``feature_generator``; 'metasr' means EDSR, as in the JAX package)."""
    c = paras.input_channel
    mode = paras.get("meta_feature_generator",
                     paras.get("feature_generator", "EDSR"))
    if mode in ("metasr", "MetaSR"):
        mode = "EDSR"
    return MetaSR(
        extractor=_make_extractor(paras, mode, dtype),
        extractor_mode=mode, in_chans=c,
        kernel_size=paras.get("meta_sr_kernel_size", 3),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        dtype=dtype, train_resolution=(paras.patch_size,) * 2,
    ).eval()
