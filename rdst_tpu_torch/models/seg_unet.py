"""Segmentation UNet (counterpart of ``rdst_tpu/models/seg_unet.py``), in
PyTorch on NCHW tensors.

smp.Unet's topology: a ResNet34 encoder, UNet decoder blocks of 256 /
128 / 64 / 32 / 16 channels (nearest x2, concat the skip, two conv + BN
+ ReLU) and a 3x3 conv head. The modules carry the flax module names, so
``checkpoint.convert.export_flax_tree`` carries a JAX variables tree
across key by key.

``forward(x)`` takes NHWC images, as the JAX module does, reflect-pads
them to a multiple of 32 and returns ``(features, decoder, logits)``:
``features`` the encoder list [x, f1 /2, f2 /4, f3 /8, f4 /16, f5 /32]
of the padded input, and the decoder output and logits cropped back, all
NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.rdst import reflect_index
from rdst_tpu_torch.nn.layers import BatchNorm


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        self.has_down = stride != 1 or cin != features
        if self.has_down:
            self.downsample_conv = nn.Conv2d(cin, features, 1, stride=stride,
                                             bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        res = (self.downsample_bn(self.downsample_conv(x), train)
               if self.has_down else x)
        return F.relu(y + res)


class ResNet34Encoder(nn.Module):
    STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        cin = 64
        for stage, (blocks, ch) in enumerate(self.STAGES):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, f"layer{stage + 1}_{b}",
                        _BasicBlock(cin, ch, stride))
                cin = ch

    def forward(self, x, train: bool = False):
        feats = [x]
        y = F.relu(self.bn1(self.conv1(x), train))
        feats.append(y)
        y = F.max_pool2d(y, 3, 2, 1)
        for stage, (blocks, _) in enumerate(self.STAGES):
            for b in range(blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y, train)
            feats.append(y)
        return feats


class _DecoderBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = _conv(cin, features, 3)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)

    def forward(self, x, skip=None, train: bool = False):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], 1)
        x = F.relu(self.bn1(self.conv1(x), train))
        return F.relu(self.bn2(self.conv2(x), train))


class SegUNet(nn.Module):
    """smp.Unet(resnet34): encoder + UNet decoder + segmentation head."""

    def __init__(self, in_channels: int = 1, classes: int = 4,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = ResNet34Encoder(in_channels)
        skips = (256, 128, 64, 64, 0)
        cin = 512
        for i, ch in enumerate(decoder_channels):
            setattr(self, f"decoder_{i}", _DecoderBlock(cin + skips[i], ch))
            cin = ch
        self.n_decoders = len(decoder_channels)
        self.segmentation_head = _conv(cin, classes, 3, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        ph, pw = (-h) % 32, (-w) % 32
        if ph:
            x = x.index_select(2, reflect_index(h, h + ph).to(x.device))
        if pw:
            x = x.index_select(3, reflect_index(w, w + pw).to(x.device))
        feats = self.encoder(x, train)
        skips = [feats[4], feats[3], feats[2], feats[1], None]
        y = feats[5]
        for i in range(self.n_decoders):
            y = getattr(self, f"decoder_{i}")(y, skips[i], train)
        logits = self.segmentation_head(y)
        return feats, y[:, :, :h, :w], logits[:, :, :h, :w]


def init_seg_unet(model: SegUNet, generator: torch.Generator) -> SegUNet:
    """Seeded initialization: conv kernels uniform within sqrt(1 / fan_in)
    (torch's default, the JAX package's ``torch_conv_init``), biases 0,
    BatchNorms one and zero with running statistics 0 and 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = m.weight[0].numel() ** -0.5
                m.weight.copy_((2 * torch.rand(m.weight.shape,
                                               generator=generator) - 1)
                               * bound)
                if m.bias is not None:
                    m.bias.zero_()
    return model
