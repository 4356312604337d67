"""VGG feature losses and the VGG19 feature stack (counterpart of
``rdst_tpu/losses/vgg.py``), used by the ``VGG*``/``Minc_VGG*`` loss
terms, the ``lpips`` metric and the FID's VGG substitute.

``VGG19Features`` is torchvision's ``vgg19().features`` truncated at a
module index, with every conv's channel count scaled by ``width`` (the
committed native substitute, ``weights/vgg19_features_native.pkl``, is
trained at 0.25). Weights come from a torchvision-format ``vgg19`` state
dict (``RDST_TPU_VGG19_PT`` or ``weights/vgg19.pt``) or from the native
pickle (``RDST_TPU_VGG19_NATIVE`` or that path), both as the JAX package
reads them: ``{'params': {'conv_i': {'kernel': HWIO, 'bias': (O,)}}}``.
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

# torchvision module index of each tap (end-exclusive slice bound)
_TAPS = {"22": 8, "54": 35}


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


class VGGLoss(nn.Module):
    """The ``VGG22``/``VGG54``/``Minc_VGG*`` loss term: MSE between the
    frozen VGG19 features of the prediction and of the target (NHWC in
    [0, 1], ImageNet-normalized; one channel repeated to three, more than
    three scored channel by channel and summed). Weights as the JAX term
    finds them: a torchvision ``vgg19`` state dict (``RDST_TPU_VGG19_PT``
    or ``weights/vgg19.pt``; for ``Minc_*`` ``RDST_TPU_MINC_VGG19_PT`` or
    ``weights/minc_vgg19.pt``), else the committed native substitute,
    else a seeded random stack with a warning. No gradient reaches the
    VGG weights; it flows through them to the prediction."""

    IMAGENET_MEAN = (0.485, 0.456, 0.406)
    IMAGENET_STD = (0.229, 0.224, 0.225)

    def __init__(self, name: str, variables=None):
        super().__init__()
        self.tap = _TAPS["54" if "54" in name else "22"]
        width = 1.0
        if variables is None:
            path = None
            if name.startswith("Minc"):
                path = os.environ.get("RDST_TPU_MINC_VGG19_PT",
                                      "weights/minc_vgg19.pt")
            variables = load_vgg19_params(self.tap, path)
        if variables is None:
            variables, width = load_native_features(self.tap)
        self.model = VGG19Features(self.tap, width)
        if variables is None:
            warnings.warn(
                f"VGGLoss({name}): no VGG19 weights found; using a frozen "
                "random-initialized VGG (structured multi-scale prior). "
                "Provide weights via RDST_TPU_VGG19_PT for the reference loss.")
            gen = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for conv in self.model.convs:
                    bound = conv.weight[0].numel() ** -0.5
                    conv.weight.copy_((2 * torch.rand(
                        conv.weight.shape, generator=gen) - 1) * bound)
                    conv.bias.zero_()
        else:
            self.model.load_variables(variables)
        self.model.requires_grad_(False)
        self.register_buffer("mean", torch.tensor(self.IMAGENET_MEAN))
        self.register_buffer("std", torch.tensor(self.IMAGENET_STD))

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(((x - self.mean) / self.std).permute(0, 3, 1, 2))

    def forward(self, pred, target, batch=None) -> torch.Tensor:
        c = pred.shape[-1]
        if c in (1, 3):
            chans = [(pred, target)] if c == 3 else [
                (pred.repeat(1, 1, 1, 3), target.repeat(1, 1, 1, 3))]
        else:
            chans = [(pred[..., i:i + 1].repeat(1, 1, 1, 3),
                      target[..., i:i + 1].repeat(1, 1, 1, 3))
                     for i in range(c)]
        loss = pred.new_zeros((), dtype=torch.float32)
        for sr, hr in chans:
            with torch.no_grad():
                f_hr = self._features(hr)
            loss = loss + torch.mean((self._features(sr) - f_hr) ** 2)
        return loss
