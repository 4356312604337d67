"""ConvNeXt-SR baseline (counterpart of ``rdst_tpu/models/convnext_sr.py``).

ConvNeXt blocks (depthwise 7x7 conv, LayerNorm with epsilon 1e-6,
pointwise MLP with exact GELU, per-channel layer scale ``gamma`` of 1e-6
at init) over a conv head, the head's output added back times
``res_scale``, PixelShuffle tail. No mean shift: the reference builds its
mean-shift layers and never applies them. lite = 64 feats x 16 blocks,
large = 192 x 32 (hard-coded in the JAX factories).

In bfloat16 the float32 ``gamma`` makes each block's output float32, as
JAX's type promotion does; the next conv rounds its input to bf16, as a
flax conv at ``dtype=bfloat16`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import Conv, UpSampler
from rdst_tpu_torch.nn.layers import LayerNorm, Linear, gelu_exact


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.norm(self.dwconv(x.to(dtype)))
        y = self.pwconv2(gelu_exact(self.pwconv1(y)))
        return x + self.gamma * y


class ConvNetSR(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 n_feats: int = 64, n_blocks: int = 16,
                 res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.n_blocks, self.res_scale = int(n_blocks), float(res_scale)
        self.head = Conv(in_chans, n_feats, 3)
        for i in range(self.n_blocks):
            self.add_module(f"body_{i}", ConvNeXtBlock(n_feats))
        self.tail_up = UpSampler(int(sr_scale), n_feats)
        self.tail_conv = Conv(n_feats, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        x = self.head(x.to(self.dtype))
        fn = x
        for i in range(self.n_blocks):
            x = getattr(self, f"body_{i}")(x, self.dtype)
        x = x + fn * self.res_scale
        return self.tail_conv(self.tail_up(x.to(self.dtype)))


def make_convnet_large(paras, mean=None, std=None,
                       dtype=torch.float32) -> ConvNetSR:
    return ConvNetSR(in_chans=paras.input_channel,
                     sr_scale=int(paras.sr_scale), n_feats=192, n_blocks=32,
                     dtype=dtype,
                     train_resolution=(paras.patch_size,) * 2).eval()


def make_convnet_lite(paras, mean=None, std=None,
                      dtype=torch.float32) -> ConvNetSR:
    return ConvNetSR(in_chans=paras.input_channel,
                     sr_scale=int(paras.sr_scale), n_feats=64, n_blocks=16,
                     dtype=dtype,
                     train_resolution=(paras.patch_size,) * 2).eval()
