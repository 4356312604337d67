"""Patch tiling for whole-image inference (unfold / fold), the port's copy
of ``rdst_tpu/data/folding.py``.

NHWC tensors on any device. The patch grid (the automatic padding rule
and the row-major patch order) is worked out on the host once per (image,
patch, stride); ``unfold`` is an index gather from the zero-padded image
and ``fold`` an ``index_add_`` of the patches' pixels, divided by the
per-pixel overlap count, which is computed once.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

Size2 = Tuple[int, int]


def _pair(v) -> Size2:
    if isinstance(v, (int, np.integer)):
        return int(v), int(v)
    return int(v[0]), int(v[1])


def _positions(size: int, kernel: int, stride: int, padding: int) -> np.ndarray:
    count = (size + 2 * padding - kernel) // stride + 1
    return -padding + stride * np.arange(count)


class ImageFolder:
    """Tile an NHWC image into patches and reassemble with overlap averaging.

    Padding is computed so that the stride grid covers the image (the
    reference ImageFolder's rule, basic_dataset.py:427-433). ``unfold``
    maps (N,H,W,C) -> (N*P, ph, pw, C); ``fold`` inverts it, dividing by
    the per-pixel overlap count.
    """

    def __init__(
        self,
        image_size: Tuple[int, int, int, int],  # N, H, W, C (NHWC)
        patch_size: Union[int, Size2],
        stride: Union[int, Size2] = 1,
    ):
        n, h, w, c = (int(v) for v in image_size)
        ph, pw = _pair(patch_size)
        sh, sw = _pair(stride)
        margin = [
            h - ((h - 1 - (ph - 1)) // sh + 1) * sh,
            w - ((w - 1 - (pw - 1)) // sw + 1) * sw,
        ]
        pad = tuple(0 if m == 0 else math.ceil((p - m) / 2)
                    for m, p in zip(margin, (ph, pw)))

        self.image_size = (n, h, w, c)
        self.patch_size = (ph, pw)
        self.stride = (sh, sw)
        self.padding = pad
        self.hs = _positions(h, ph, sh, pad[0])
        self.ws = _positions(w, pw, sw, pad[1])
        self.num_patches = len(self.hs) * len(self.ws)
        # flat pixel index into one zero-padded image of every patch pixel,
        # in (patch row, patch col, pixel row, pixel col) order
        wp = w + 2 * pad[1]
        r = self.hs[:, None] + np.arange(ph)[None, :] + pad[0]  # (Lh, ph)
        col = self.ws[:, None] + np.arange(pw)[None, :] + pad[1]  # (Lw, pw)
        self._index = torch.from_numpy(
            (r[:, None, :, None] * wp + col[None, :, None, :]).reshape(-1))
        counts = np.bincount(self._index.numpy(),
                             minlength=(h + 2 * pad[0]) * wp)
        counts = counts.reshape(h + 2 * pad[0], wp)[pad[0]:pad[0] + h,
                                                   pad[1]:pad[1] + w]
        self._inv_divisor = torch.from_numpy(
            (1.0 / np.maximum(counts, 1e-12)).astype(np.float32))[..., None]

    def unfold(self, x: torch.Tensor) -> torch.Tensor:
        """(N,H,W,C) -> (N*Lh*Lw, ph, pw, C), row-major patch order."""
        n, h, w, c = x.shape
        p0, p1 = self.padding
        xp = torch.nn.functional.pad(x, (0, 0, p1, p1, p0, p0))
        flat = xp.reshape(n, -1, c)
        idx = self._index.to(x.device)
        ph, pw = self.patch_size
        return flat[:, idx].reshape(n * self.num_patches, ph, pw, c)

    def fold(self, patches: torch.Tensor) -> torch.Tensor:
        """(N*P, ph, pw, C) -> (N,H,W,C) with overlap-count normalization."""
        n, h, w, c = self.image_size
        p0, p1 = self.padding
        hp, wp = h + 2 * p0, w + 2 * p1
        src = patches.reshape(n, -1, c)
        out = patches.new_zeros((n, hp * wp, c))
        out.index_add_(1, self._index.to(patches.device), src)
        out = out.reshape(n, hp, wp, c)[:, p0:p0 + h, p1:p1 + w, :]
        return out * self._inv_divisor.to(out.device, out.dtype)
