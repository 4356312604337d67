"""Fréchet Inception Distance (counterpart of ``rdst_tpu/metrics/fid.py``).

The feature extractor is chosen as the JAX package chooses it:

* InceptionV3 pool3 features (``metrics/inception.py``) when a
  pytorch-fid weights file is present (``RDST_TPU_INCEPTION_PT`` or
  ``rdst_tpu_torch/metrics/pt_inception-2015-12-05-6726825d.pth``);
* else the committed VGG substitute (``weights/vgg19_features_native.pkl``,
  ``RDST_TPU_VGG19_NATIVE``): VGG19 features at tap '54', global average
  pooled, each batch cropped to its smallest image;
* else the seeded random projection (a one-time warning says the values
  are not comparable to published FIDs).

The networks run on the device of ``gpu_id`` (-1: the CPU; else
``cuda:gpu_id``, which must exist), moved there at the first score.
Single-channel (or any non-RGB) images are scored one channel at a time,
each repeated to 3 channels, and the per-channel FIDs averaged.

The Fréchet distance takes the trace of the matrix square root in its
symmetric form, tr sqrt(sqrt(S1) S2 sqrt(S1)), by float64 ``eigh`` with
negative eigenvalues clamped to 0: the same eigenvalues as sqrtm(S1 S2)
for covariance matrices, without scipy.
"""

from __future__ import annotations

import os
import warnings
from typing import List

import numpy as np
import torch


def _psd_sqrt(s: np.ndarray) -> np.ndarray:
    """Symmetric square root of a positive semidefinite matrix."""
    w, v = np.linalg.eigh((s + s.T) / 2)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """Fréchet distance between two Gaussians; nan on non-finite moments,
    as the JAX function returns it."""
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    if not (np.isfinite(sigma1).all() and np.isfinite(sigma2).all()
            and np.isfinite(diff).all()):
        warnings.warn("frechet_distance: non-finite moments; returning nan")
        return float("nan")
    r1 = _psd_sqrt(sigma1)
    m = r1 @ sigma2 @ r1
    tr_covmean = np.sqrt(np.clip(np.linalg.eigvalsh((m + m.T) / 2), 0.0,
                                 None)).sum()
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)


def _rgb(img) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[..., :3]


class RandomProjectionFeatures:
    """Deterministic conv-pool random features (the last fallback), the
    JAX package's draw: numpy ``default_rng(seed)``."""

    def __init__(self, dim: int = 256, patch: int = 16, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.patch = patch
        self.w = rng.normal(0, 1.0 / patch,
                            (dim, 3 * patch * patch)).astype(np.float32)

    def __call__(self, imgs: List[np.ndarray]) -> np.ndarray:
        feats = []
        p = self.patch
        for img in imgs:
            img = _rgb(img)
            h, w = img.shape[:2]
            hh, ww = (h // p) * p, (w // p) * p
            x = img[:hh, :ww].reshape(hh // p, p, ww // p, p, 3)
            x = x.transpose(0, 2, 4, 1, 3).reshape(-1, 3 * p * p)
            feats.append(np.maximum(x @ self.w.T, 0).mean(axis=0))
        return np.stack(feats)


class NativeVGGFeatures:
    """Global-average-pooled VGG19 features of the committed substitute,
    in batches of ``batch_size`` cropped to their smallest image."""

    def __init__(self, variables, width: float, batch_size: int = 16,
                 device="cpu"):
        from rdst_tpu_torch.losses.vgg import _TAPS, VGG19Features

        self.model = VGG19Features(_TAPS["54"], width).load_variables(
            variables).eval().to(device)
        self.batch_size = batch_size
        self.device = torch.device(device)

    @torch.no_grad()
    def __call__(self, imgs: List[np.ndarray]) -> np.ndarray:
        out = []
        for i in range(0, len(imgs), self.batch_size):
            block = [_rgb(img) for img in imgs[i:i + self.batch_size]]
            h = min(b.shape[0] for b in block)
            w = min(b.shape[1] for b in block)
            x = torch.from_numpy(np.stack([b[:h, :w] for b in block]))
            f = self.model(x.to(self.device).permute(0, 3, 1, 2))
            out.append(f.mean(dim=(2, 3)).float().cpu().numpy())
        return np.concatenate(out)


_warned = False


class FID:
    """Callable ``FID(gts, preds)`` over lists of HWC images."""

    def __init__(self, gpu_id: int = -1, block_idx: int = 3,
                 batch_size: int = 16):
        global _warned
        self.device = ("cpu" if gpu_id is None or int(gpu_id) < 0
                       else f"cuda:{int(gpu_id)}")
        self.batch_size = batch_size
        self.extractor = None
        self._inception = None
        weights = os.environ.get(
            "RDST_TPU_INCEPTION_PT",
            os.path.join(os.path.dirname(__file__),
                         "pt_inception-2015-12-05-6726825d.pth"))
        if os.path.exists(weights):
            try:
                from rdst_tpu_torch.metrics.inception import load_fid_inception

                self._inception = load_fid_inception(weights)
            except Exception as e:  # a broken file falls back, as in JAX
                warnings.warn(f"could not load inception weights: {e}")
        if self._inception is None:
            from rdst_tpu_torch.losses.vgg import _TAPS, load_native_features

            self._vgg = load_native_features(_TAPS["54"])
            if self._vgg[0] is None:
                if not _warned:
                    warnings.warn(
                        "FID: inception weights unavailable; using "
                        "random-projection features (values not comparable "
                        "to published FIDs).")
                    _warned = True
                self.extractor = RandomProjectionFeatures()

    def _extractor(self):
        """The network extractor on its device, made at the first score
        (the card is asked for only then)."""
        if self.extractor is None:
            from rdst_tpu_torch.device import resolve_device

            dev = resolve_device(self.device)
            if self._inception is not None:
                from rdst_tpu_torch.metrics.inception import InceptionFeatures

                self.extractor = InceptionFeatures(self._inception,
                                                   self.batch_size, dev)
            else:
                self.extractor = NativeVGGFeatures(*self._vgg,
                                                   self.batch_size, dev)
        return self.extractor

    def _stats(self, imgs):
        act = self._extractor()(list(imgs))
        return act.mean(axis=0), np.cov(act, rowvar=False)

    def _fid(self, gts, preds) -> float:
        mu1, s1 = self._stats(gts)
        mu2, s2 = self._stats(preds)
        return frechet_distance(mu1, s1, mu2, s2)

    @staticmethod
    def _hwc(img) -> np.ndarray:
        img = np.asarray(img, np.float32)
        return img[:, :, None] if img.ndim == 2 else img

    def __call__(self, gts, preds) -> float:
        gts = [self._hwc(g) for g in gts]
        preds = [self._hwc(p) for p in preds]
        c = gts[0].shape[-1]
        if c == 3:
            return self._fid(gts, preds)
        vals = []
        for ch in range(c):
            g = [np.repeat(x[..., ch:ch + 1], 3, axis=-1) for x in gts]
            p = [np.repeat(x[..., ch:ch + 1], 3, axis=-1) for x in preds]
            vals.append(self._fid(g, p))
        return float(np.mean(vals))
