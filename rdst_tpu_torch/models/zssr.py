"""ZSSR network (counterpart of ``rdst_tpu/models/zssr.py``).

A plain fully convolutional net that maps an LR slice already
interpolated to the output size (``lr_image_size_remain = True``: the
datasets feed ``in = res``) to the same size, learning the residual. It
does not upsample.
"""

from __future__ import annotations

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import Conv
from rdst_tpu_torch.nn.layers import activation, resolve_act


class ZSSRNet(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors of the output size;
    the scale is not read."""

    def __init__(self, in_chans: int = 1, inside_channel: int = 64,
                 num_layers: int = 8, residual: bool = True,
                 act: str = "relu", dtype: torch.dtype = torch.float32,
                 train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.n_body, self.residual = int(num_layers) - 2, bool(residual)
        self.act = activation(act)
        self.head = Conv(in_chans, inside_channel, 3)
        for i in range(self.n_body):
            self.add_module(f"body_{i}",
                            Conv(inside_channel, inside_channel, 3))
        self.tail = Conv(inside_channel, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        x = x.to(self.dtype)
        y = self.act(self.head(x))
        for i in range(self.n_body):
            y = self.act(getattr(self, f"body_{i}")(y))
        y = self.tail(y)
        return x + y if self.residual else y


def make_zssr(paras, mean=None, std=None, dtype=torch.float32) -> ZSSRNet:
    """Factory keyed off the reference config names (``zssr_*``)."""
    return ZSSRNet(
        in_chans=paras.input_channel,
        inside_channel=paras.get("zssr_n_feats", 64),
        num_layers=paras.get("zssr_num_layers", 8),
        residual=paras.get("zssr_residual", True),
        act=resolve_act(paras, paras.get("zssr_act", "relu")),
        dtype=dtype, train_resolution=(paras.patch_size,) * 2,
    ).eval()
