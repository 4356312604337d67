"""Conditional PatchGAN discriminator and GANLoss (counterpart of
``rdst_tpu/losses/patchgan.py``; the reference's networks/PatchGAN.py).

The PatchGAN scores concatenated (condition, image) pairs with a
stride-2 pyramid of 4x4 convolutions (padding 1), InstanceNorm and
LeakyReLU 0.2, down to a patch-level prediction map. ``GANLoss`` covers
lsgan (MSE), vanilla (BCE on logits) and wgangp (mean) modes, and
:func:`gradient_penalty` the mixed-interpolation penalty. Images are NHWC
at the interface, as in the JAX package; the convolutions carry the flax
module names (``conv_0`` ... ``conv_out``), so
``checkpoint.convert.export_flax_tree`` / ``import_flax_tree`` carry the
weights both ways. Neither package has a caller or a config for it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F


class InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial normalization of an NCHW map
    (torch ``InstanceNorm2d`` without affine; biased variance)."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = float(epsilon)

    def forward(self, x):
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.epsilon)


class PatchGAN(nn.Module):
    """``PatchGAN(ndf, n_layers)`` over images whose channels add up to
    ``in_channels`` once concatenated."""

    def __init__(self, in_channels: int = 2, ndf: int = 64,
                 n_layers: int = 3):
        super().__init__()
        self.n_layers = int(n_layers)

        def conv(cin, cout, stride):
            return nn.Conv2d(cin, cout, 4, stride, padding=1)

        self.conv_0 = conv(in_channels, ndf, 2)
        cin = ndf
        for n in range(1, self.n_layers):
            cout = ndf * min(2 ** n, 8)
            setattr(self, f"conv_{n}", conv(cin, cout, 2))
            cin = cout
        cout = ndf * min(2 ** self.n_layers, 8)
        setattr(self, f"conv_{self.n_layers}", conv(cin, cout, 1))
        self.conv_out = conv(cout, 1, 1)
        self.norm = InstanceNorm()

    def forward(self, img_a, img_b):
        x = torch.cat([img_a, img_b], dim=-1).permute(0, 3, 1, 2)
        x = F.leaky_relu(self.conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            x = F.leaky_relu(self.norm(getattr(self, f"conv_{n}")(x)), 0.2)
        return self.conv_out(x).permute(0, 2, 3, 1)  # patch prediction map


class GANLoss:
    """Target-label abstraction (PatchGAN.py:59-127)."""

    def __init__(self, gan_mode: str, target_real: float = 1.0,
                 target_fake: float = 0.0):
        if gan_mode not in ("lsgan", "vanilla", "wgangp"):
            raise ValueError(f"gan_mode {gan_mode!r}: expected lsgan, "
                             "vanilla or wgangp")
        self.gan_mode = gan_mode
        self.target_real = target_real
        self.target_fake = target_fake

    def __call__(self, prediction, target_is_real: bool):
        if self.gan_mode == "wgangp":
            return -prediction.mean() if target_is_real else prediction.mean()
        target = torch.full_like(
            prediction, self.target_real if target_is_real else self.target_fake)
        if self.gan_mode == "lsgan":
            return torch.mean((prediction - target) ** 2)
        return F.binary_cross_entropy_with_logits(prediction, target)


def gradient_penalty(d_apply: Callable, real, fake,
                     generator: Optional[torch.Generator] = None,
                     constant: float = 1.0, lambda_gp: float = 10.0,
                     mode: str = "mixed", alpha=None):
    """Mixed-interpolation gradient penalty (PatchGAN.py:129-160):
    ``lambda_gp * mean((|grad d_apply(hat)| - constant)^2)`` at ``hat`` the
    real batch, the fake one, or (``mode='mixed'``) ``alpha real + (1 -
    alpha) fake`` with ``alpha`` (B, 1, 1, 1) uniform draws from
    ``generator`` (or the given ``alpha``). Differentiable."""
    if mode == "real":
        hat = real
    elif mode == "fake":
        hat = fake
    else:
        if alpha is None:
            alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator,
                               device=real.device)
        hat = alpha * real + (1 - alpha) * fake
    if not hat.requires_grad:
        hat = hat.detach().requires_grad_(True)
    grads = torch.autograd.grad(d_apply(hat).sum(), hat, create_graph=True)[0]
    gnorm = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=1) + 1e-16)
    return lambda_gp * torch.mean((gnorm - constant) ** 2)
