"""LPIPS-style perceptual distance over the committed VGG feature stack
(the port's copy of ``rdst_tpu/metrics/perceptual.py``).

The LPIPS construction (Zhang et al. 2018): unit-normalize each tapped
layer's features along the channel axis, take squared differences,
average spatially and over channels, and sum across layers. As in the
JAX package, the backbone is the repo's natively trained width-0.25 VGG19
substitute (``weights/vgg19_features_native.pkl``) unless a torchvision
``vgg19`` state dict is given, and the per-layer calibration is uniform
(the channel mean) instead of LPIPS's learned 1x1 weights: values compare
within this repo, not with published LPIPS numbers. Lower is better.

It runs on the CPU in float32: a host-side metric, called once per image
by the evaluation loop, whatever device the model runs on.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# torchvision-numbered module counts of the taps: outputs after relu1_2,
# relu2_2, relu3_4, relu4_4, relu5_4 (the five LPIPS depths)
_TAP_BOUNDS: Tuple[int, ...] = (4, 9, 18, 27, 36)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=1)
def _backbone():
    """The feature stack down to the deepest tap, on the CPU, in eval
    mode: a torchvision vgg19 when one is given, else the committed
    native substitute."""
    from rdst_tpu_torch.losses.vgg import (VGG19Features,
                                           load_native_features,
                                           load_vgg19_params)

    max_tap = max(_TAP_BOUNDS)
    variables, width = load_vgg19_params(max_tap), 1.0
    if variables is None:
        variables, width = load_native_features(max_tap)
    if variables is None:
        raise FileNotFoundError(
            "lpips metric: no VGG weights (weights/vgg19.pt or "
            "weights/vgg19_features_native.pkl, or RDST_TPU_VGG19_PT / "
            "RDST_TPU_VGG19_NATIVE)")
    return VGG19Features(max_tap, width).load_variables(variables).eval()


def _to_rgb_nhwc(img: np.ndarray) -> np.ndarray:
    """HWC (any C) float -> NHWC 3-channel f32, grey replicated (the
    reference's VGG-loss convention); several channels are averaged into
    one plane first."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] != 3:
        img = np.repeat(img.mean(-1, keepdims=True), 3, axis=-1)
    return img[None]


def _distance(gt: np.ndarray, p: np.ndarray) -> float:
    net = _backbone()
    mean = torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1)
    x = torch.from_numpy(np.concatenate([gt, p])).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = net.taps((x - mean) / std, _TAP_BOUNDS)
        total = torch.zeros(())
        for f in feats:
            n = f * torch.rsqrt(torch.sum(f * f, 1, keepdim=True) + 1e-10)
            total = total + torch.mean((n[0] - n[1]) ** 2)
    return float(total)


def lpips(gt, p) -> float:
    """LPIPS-style perceptual distance (lower = closer). HWC in [0,1]."""
    gt = _to_rgb_nhwc(gt)
    p = _to_rgb_nhwc(p)
    h, w = gt.shape[1:3]
    # four pools before the deepest tap: pad to a multiple of 16,
    # reflectively (no synthetic edges for the conv stack to react to)
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:
        pad = ((0, 0), (0, ph), (0, pw), (0, 0))
        gt = np.pad(gt, pad, mode="reflect")
        p = np.pad(p, pad, mode="reflect")
    return _distance(gt, p)
