"""The VGG19 feature stack (the port's copy of the feature part of
``rdst_tpu/losses/vgg.py``), used by the ``lpips`` metric.

``VGG19Features`` is torchvision's ``vgg19().features`` truncated at a
module index, with every conv's channel count scaled by ``width`` (the
committed native substitute, ``weights/vgg19_features_native.pkl``, is
trained at 0.25). Weights come from a torchvision-format ``vgg19`` state
dict (``RDST_TPU_VGG19_PT`` or ``weights/vgg19.pt``) or from the native
pickle (``RDST_TPU_VGG19_NATIVE`` or that path), both as the JAX package
reads them: ``{'params': {'conv_i': {'kernel': HWIO, 'bias': (O,)}}}``.
The VGG losses themselves wait for the losses slice (ROADMAP Queue A 7).
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG19 feature config: conv channel per layer, 'M' = maxpool
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _convs_below(tap: int) -> int:
    """Number of convs among the first ``tap`` torchvision modules (a conv
    and its ReLU are two modules, a pool one)."""
    convs = module_idx = 0
    for item in _VGG19_CFG:
        if module_idx >= tap:
            break
        if item == "M":
            module_idx += 1
        else:
            convs += 1
            module_idx += 2
    return convs


class VGG19Features(nn.Module):
    """VGG19 ``.features`` truncated at ``tap`` modules (torchvision
    numbering), on NCHW inputs. ``width`` scales every conv's channels
    (at least 8), as the JAX module does."""

    def __init__(self, tap: int, width: float = 1.0):
        super().__init__()
        self.tap, self.width = int(tap), float(width)
        chans = [max(8, int(c * width)) for c in _VGG19_CFG if c != "M"]
        n = _convs_below(self.tap)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for cin, cout in zip([3] + chans[:n - 1], chans[:n]))

    def taps(self, x: torch.Tensor, bounds: Sequence[int]):
        """The activations after each module count in ``bounds`` (a
        count after a conv is its output before the ReLU)."""
        bounds = tuple(bounds)
        out, module_idx, conv_idx = [], 0, 0
        for item in _VGG19_CFG:
            if module_idx >= max(bounds):
                break
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                module_idx += 1
            else:
                x = self.convs[conv_idx](x)
                conv_idx += 1
                module_idx += 1
                if module_idx in bounds:
                    out.append(x)
                if module_idx >= max(bounds):
                    break
                x = F.relu(x)
                module_idx += 1
            if module_idx in bounds:
                out.append(x)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.taps(x, (self.tap,))[0]

    def load_variables(self, variables: dict) -> "VGG19Features":
        """Take ``{'params': {'conv_i': {'kernel': HWIO, 'bias'}}}``
        (strictly: one entry per conv of the truncated stack)."""
        params = variables["params"]
        if len(params) != len(self.convs):
            raise ValueError(f"{len(params)} convs given for a stack of "
                             f"{len(self.convs)}")
        with torch.no_grad():
            for i, conv in enumerate(self.convs):
                p = params[f"conv_{i}"]
                conv.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(np.asarray(p["kernel"], np.float32)
                                         .transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(
                    np.asarray(p["bias"], np.float32)))
        return self


def load_vgg19_params(tap: int, path: Optional[str] = None):
    """A torchvision vgg19 state dict -> the truncated stack's variables,
    or None when the file is absent."""
    from rdst_tpu_torch.checkpoint.loading import read_torch_state_dict

    path = path or os.environ.get("RDST_TPU_VGG19_PT", "weights/vgg19.pt")
    if not os.path.exists(path):
        return None
    sd = read_torch_state_dict(path)
    params = {}
    conv_idx = module_idx = 0
    for item in _VGG19_CFG:
        if module_idx >= tap:
            break
        if item == "M":
            module_idx += 1
            continue
        w = sd[f"features.{module_idx}.weight"].numpy().transpose(2, 3, 1, 0)
        b = sd[f"features.{module_idx}.bias"].numpy()
        params[f"conv_{conv_idx}"] = {"kernel": w, "bias": b}
        conv_idx += 1
        module_idx += 2  # conv + relu
    return {"params": params}


def load_native_features(tap: int, path: Optional[str] = None):
    """The natively trained substitute stack (a pickle of ``{'width',
    'params'}`` that the JAX package's ``train_vgg_features`` writes),
    truncated to ``tap``. Returns ``(variables | None, width)``."""
    path = path or os.environ.get("RDST_TPU_VGG19_NATIVE",
                                  "weights/vgg19_features_native.pkl")
    if not os.path.exists(path):
        return None, 1.0
    with open(path, "rb") as f:
        blob = pickle.load(f)
    keep = {f"conv_{i}" for i in range(_convs_below(tap))}
    params = {k: v for k, v in blob["params"].items() if k in keep}
    if set(params) != keep:
        warnings.warn(
            f"native VGG blob at {path} lacks convs "
            f"{sorted(keep - set(params))} for tap {tap}; ignoring it")
        return None, 1.0
    return {"params": params}, float(blob.get("width", 1.0))
