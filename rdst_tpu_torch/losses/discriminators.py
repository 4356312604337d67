"""GAN discriminators (counterpart of ``rdst_tpu/losses/discriminators.py``):
the CNN discriminator and the Swin-transformer discriminator, in float32.

Both take NHWC images and ``forward(x, train)``: with ``train`` their
BatchNorms normalize by the batch and move their running statistics, as
flax's ``BatchNorm(use_running_average=not train)`` does (``nn.layers.
BatchNorm``). The modules carry the flax module names, so the JAX
variables cross with ``checkpoint.convert.export_discriminator``.

* CNN: ``depth + 1`` BasicBlocks (conv, BN, activation; stride 2 at the
  even ones, the channels doubled at the odd ones) on NCHW, then two
  dense layers. The port flattens the last map in NCHW order; the JAX
  module flattens NHWC, so ``classifier_0``'s rows are reordered when
  weights cross (``map_chw``).
* Swin: a conv head, then RSTB4GAN stages (a Swin stack, a conv, the
  residual, a conv or patch-merging downsampling) at fixed resolutions
  (inputs cropped or edge-padded to ``input_resolution``), then two dense
  layers on the NHWC flatten.

BatchNorm is off for the ``*GP*`` types.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rdst_tpu_torch.models.rdst import to_image, to_tokens
from rdst_tpu_torch.nn.common import Conv
from rdst_tpu_torch.nn.layers import BatchNorm, Linear, activation
from rdst_tpu_torch.nn.swin import BasicLayer, PatchMerging


class BasicBlock(nn.Module):
    """conv (no bias) + optional BN + activation, on NCHW."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, bn: bool = True,
                 act: Optional[str] = "leaky_relu", act_slope: float = 0.2):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel_size, stride=stride,
                              padding=kernel_size // 2, bias=False)
        self.bn = BatchNorm(features) if bn else None
        self.act = activation(act, act_slope)

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train)
        return self.act(x)


# flax's default kernel init, lecun_normal: a normal cut at 2 std and
# scaled by 1 / 0.8796 (the cut's std), so that its variance is 1 / fan_in
_CUT_STD = 0.87962566103423978


def init_discriminator(d: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers (``runners.trainer.init_weights``),
    but the BasicBlock convs, which set no ``kernel_init`` in the JAX
    package (``rdst_tpu/losses/discriminators.py:38``) and so take flax's
    lecun_normal."""
    from rdst_tpu_torch.runners.trainer import init_weights, truncated_normal

    init_weights(d, generator)
    with torch.no_grad():
        for m in d.modules():
            if isinstance(m, BasicBlock):
                w = m.conv.weight
                truncated_normal(w, generator, w[0].numel() ** -0.5 / _CUT_STD)


def _conv_out(n: int) -> int:
    """Output extent of a 3x3, stride 2, padding 1 conv."""
    return (n - 1) // 2 + 1


class CNNDiscriminator(nn.Module):
    def __init__(self, in_chans: int = 1, base_features: int = 64,
                 depth: int = 7, patch_size=96, bn: bool = True,
                 act: str = "leaky_relu", act_slope: float = 0.2):
        super().__init__()
        h, w = ((patch_size, patch_size) if isinstance(patch_size, int)
                else tuple(patch_size))
        ch = base_features
        self.features_0 = BasicBlock(in_chans, ch, 3, bn=bn, act=act,
                                     act_slope=act_slope)
        for i in range(depth):
            cin = ch
            if i % 2 == 1:
                stride, ch = 1, ch * 2
            else:
                stride = 2
                h, w = _conv_out(h), _conv_out(w)
            setattr(self, f"features_{i + 1}",
                    BasicBlock(cin, ch, 3, stride=stride, bn=bn, act=act,
                               act_slope=act_slope))
        self.depth = depth
        self.map_chw = (ch, h, w)  # the last map, flattened in NCHW order
        self.classifier_0 = Linear(ch * h * w, 1024)
        self.classifier_1 = Linear(1024, 1)
        self.act = activation(act, act_slope)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.depth + 1):
            x = getattr(self, f"features_{i}")(x, train)
        x = self.act(self.classifier_0(x.reshape(x.shape[0], -1)))
        return self.classifier_1(x)


class _Conv(nn.Module):
    """The JAX package's ``nn.common.Conv`` (a conv named ``conv`` inside a
    module), on NHWC."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = Conv(cin, cout, k)

    def forward(self, x):
        return self.conv(x)


class RSTB4GAN(nn.Module):
    """A Swin stack + conv + residual, then a downsampling: 'conv' (a
    stride-2 BasicBlock to 2C), 'patchmerging' or ''. NHWC in and out."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, x_size: Tuple[int, int],
                 downsample: str = "conv", bn: bool = False,
                 act: Optional[str] = None):
        super().__init__()
        self.x_size, self.downsample = tuple(x_size), downsample
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         mlp_ratio=4.0,
                                         build_resolution=self.x_size)
        self.conv = _Conv(dim, dim, 3)
        if downsample == "conv":
            self.downsample_layer = BasicBlock(dim, dim * 2, 3, stride=2,
                                               bn=bn, act=act)
        elif downsample == "patchmerging":
            self.downsample_layer = PatchMerging(dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        tokens, _ = to_tokens(x)
        y = self.residual_group(tokens, self.x_size)
        y = self.conv(to_image(y, self.x_size))
        tokens = to_tokens(y)[0] + tokens
        if self.downsample == "conv":
            img = to_image(tokens, self.x_size).permute(0, 3, 1, 2)
            return self.downsample_layer(img, train).permute(0, 2, 3, 1)
        if self.downsample == "patchmerging":
            merged = self.downsample_layer(tokens, self.x_size)
            return to_image(merged, (self.x_size[0] // 2,
                                     self.x_size[1] // 2))
        return to_image(tokens, self.x_size)


class STDiscriminator(nn.Module):
    def __init__(self, in_chans: int = 1, basic_dim: int = 64,
                 input_resolution: Tuple[int, int] = (96, 96),
                 num_heads: Sequence[int] = (4, 4, 4),
                 depth: Sequence[int] = (2, 2, 2),
                 window_size: Sequence[int] = (8, 8, 8),
                 downsample: str = "conv", bn: bool = True,
                 act: str = "leaky_relu", act_slope: float = 0.2):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.head = BasicBlock(in_chans, basic_dim, 3, bn=bn, act=act,
                               act_slope=act_slope)
        dim, x_size = basic_dim, self.input_resolution
        self.n_blocks = len(num_heads)
        for i, (nh, d, ws) in enumerate(zip(num_heads, depth, window_size)):
            setattr(self, f"blocks_{i}",
                    RSTB4GAN(dim, d, nh, ws, x_size, downsample))
            dim *= 2
            x_size = (x_size[0] // 2, x_size[1] // 2)
        self.classifier_0 = Linear(dim * x_size[0] * x_size[1], 1024)
        self.classifier_1 = Linear(1024, 1)
        self.act = activation(act, act_slope)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        rh, rw = self.input_resolution
        x = x[:, :rh, :rw]
        ph, pw = rh - x.shape[1], rw - x.shape[2]
        if ph > 0:
            x = torch.cat([x, x[:, -1:].expand(-1, ph, -1, -1)], 1)
        if pw > 0:
            x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw, -1)], 2)
        x = self.head(x.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"blocks_{i}")(x, train)
        x = self.act(self.classifier_0(x.reshape(x.shape[0], -1)))
        return self.classifier_1(x)


def is_st_type(gan_type: str) -> bool:
    return "ST" in gan_type or "st" in gan_type.replace("Scale", "")


def build_discriminator(paras) -> nn.Module:
    """The discriminator of ``paras.gan_type``, as the JAX package builds
    it."""
    gan_type = paras.gan_type
    bn = "GP" not in gan_type
    act = paras.get("d_act", "leaky_relu")
    slope = float(paras.get("leaky_relu_slope", 0.2) or 0.2)
    if is_st_type(gan_type):
        return STDiscriminator(
            in_chans=paras.input_channel,
            basic_dim=paras.get("stgan_dim", 64),
            input_resolution=tuple(paras.get(
                "stgan_input_resolution",
                (int(paras.patch_size * paras.sr_scale),) * 2)),
            num_heads=tuple(paras.get("stgan_num_heads", (4, 4, 4))),
            depth=tuple(paras.get("stgan_depth", (2, 2, 2))),
            window_size=tuple(paras.get("stgan_window_size", (8, 8, 8))),
            downsample=paras.get("stgan_downsample", "conv"),
            bn=bn, act=act, act_slope=slope)
    return CNNDiscriminator(
        in_chans=paras.input_channel,
        base_features=paras.get("gan_d_base_features", 64),
        depth=paras.get("gan_d_depth", 7),
        patch_size=int(paras.patch_size * paras.sr_scale),
        bn=bn, act=act, act_slope=slope)
