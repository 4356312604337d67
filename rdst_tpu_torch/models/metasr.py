"""Meta-SR: a feature extractor + ``MetaUpSampler`` (counterpart of
``rdst_tpu/models/metasr.py``).

The port builds the EDSR extractor (``meta_feature_generator = 'EDSR'``,
the shipped config's); the JAX package's other extractors raise.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels, make_edsr
from rdst_tpu_torch.models.meta_upscale import MetaUpSampler, scale_value
from rdst_tpu_torch.nn.common import mean_shift

_OTHER_EXTRACTORS = ("SRResNet", "SRDenseNet", "RDN", "ESRGAN", "Meta_MDSR")


class MetaSR(NoKernels, nn.Module):
    """``forward(x, sr_scale)``: NHWC LR -> (N, int(s*H), int(s*W), C).
    The scale is required: the JAX module's default of 2.0 is not
    copied, so no caller runs it at a scale it did not ask for."""

    def __init__(self, extractor: nn.Module, n_feats: int, in_chans: int = 1,
                 kernel_size: int = 3, mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.mean, self.std = tuple(mean), tuple(std)
        self.extractor = extractor
        self.meta_upsampler = MetaUpSampler(n_feats, in_chans, kernel_size)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        scale = scale_value(sr_scale)
        x = mean_shift(x.to(self.dtype), self.mean, self.std, "sub")
        feats = self.extractor(x)
        out = self.meta_upsampler(feats, scale)
        return mean_shift(out, self.mean, self.std, "add")


def make_metasr(paras, mean=None, std=None, dtype=torch.float32) -> MetaSR:
    """Factory: the extractor named by ``meta_feature_generator`` (else
    ``feature_generator``; 'metasr' means EDSR, as in the JAX package)."""
    c = paras.input_channel
    mode = paras.get("meta_feature_generator",
                     paras.get("feature_generator", "EDSR"))
    if mode in ("metasr", "MetaSR"):
        mode = "EDSR"
    if mode in _OTHER_EXTRACTORS:
        raise NotImplementedError(
            f"MetaSR extractor {mode!r} is not ported (the port builds "
            "'EDSR'; the others come with the rest of the model zoo, "
            "ROADMAP Queue A 8)")
    if mode != "EDSR":
        raise ValueError(
            "LR feature extractor should be one of "
            "[EDSR, SRResNet, SRDenseNet, RDN, ESRGAN, Meta_MDSR]")
    return MetaSR(
        extractor=make_edsr(paras, dtype=dtype, feature_maps_only=True),
        n_feats=paras.get("edsr_n_feats", 64),
        in_chans=c,
        kernel_size=paras.get("meta_sr_kernel_size", 3),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
