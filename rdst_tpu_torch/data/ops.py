"""Host-side (numpy) image ops for the data pipeline: the port's own copy
of ``rdst_tpu/data/ops.py`` without cv2, which the card's machine lacks.

LR training inputs are made by cv2's INTER_CUBIC, which defines the SR
task itself. :func:`resize` reproduces it with the separable resampling
matrices of ``rdst_tpu/data/ops_jax.py`` (A = -0.75, half-pixel centres,
replicated border), computed in float64; the tests hold it against cv2.

RNG discipline: every stochastic op takes an explicit
``rng: np.random.Generator``, as in the JAX package, so the same
generator state draws the same crops.
"""

from __future__ import annotations

import functools
import math
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

Size2 = Tuple[int, int]


def normalize(imgs: np.ndarray):
    """Min/max normalize to [0, 1]; returns (normed, min, max)."""
    min_val = np.min(imgs)
    max_val = np.max(imgs)
    return (imgs - min_val) / (max_val - min_val), min_val, max_val


def _out_size(img: np.ndarray, size) -> Size2:
    if isinstance(size, (float, int)):
        size = [size, size]
    if not isinstance(size, (list, tuple)):
        raise TypeError("resize size must be float, int, list or tuple")
    if isinstance(size[0], float):
        size = int(img.shape[0] * size[0]), int(img.shape[1] * size[1])
    if size[0] <= 0 or size[1] <= 0:
        raise ValueError("resize output size must be positive")
    return int(size[0]), int(size[1])


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Bicubic convolution kernel with cv2's A = -0.75."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1.0, (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a,
                 0.0))


@functools.lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int,
                    method: str = "cubic") -> np.ndarray:
    """Dense (out_size, in_size) float64 1-D resampling matrix of cv2's
    resize (``rdst_tpu/data/ops_jax.py::resample_matrix``): half-pixel
    centres src = (dst + 0.5) * in / out - 0.5, border-replicated taps
    (a tap past the border adds its weight to the border sample);
    'nearest' is cv2's floor(dst * in / out)."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    if method == "nearest":
        m = np.zeros((out_size, in_size), dtype=np.float64)
        idx = np.minimum(np.floor(dst * scale).astype(np.int64), in_size - 1)
        m[np.arange(out_size), idx] = 1.0
        return m
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    if method == "cubic":
        offsets = np.arange(-1, 3)
        w = _cubic_kernel(frac[:, None] - offsets[None, :])
    elif method == "linear":
        offsets = np.arange(0, 2)
        w = np.stack([1.0 - frac, frac], axis=1)
    else:
        raise ValueError(f"unknown resample method: {method}")
    w = w / w.sum(axis=1, keepdims=True)
    taps = np.clip(base[:, None] + offsets[None, :], 0, in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(m, (np.repeat(np.arange(out_size), len(offsets)),
                  taps.ravel()), w.ravel())
    return m


def resize(
    img: np.ndarray,
    size,
    interpolation: Optional[str] = "cubic",
    blur_method: Optional[str] = None,
    blur_kernel: int = 3,
    blur_sigma: float = 0.0,
) -> np.ndarray:
    """cv2's resize in (rows, cols) convention, without cv2: two
    separable products with :func:`resample_matrix`, in float64, returned
    in the input's float type (float32 or float64, as cv2 returns it).

    ``size`` is (H, W) or a scalar/pair of float scale factors. Keeps a
    trailing channel axis. The gaussian blur option is not ported and
    raises, as does an interpolation this module lacks: it never changes
    method quietly."""
    h, w = _out_size(img, size)
    if blur_method == "gaussian":
        raise NotImplementedError(
            "resize(blur_method='gaussian'): cv2.GaussianBlur is not ported "
            "(no shipped config sets blur_method)")
    if blur_method:
        raise ValueError(f"unknown blur_method {blur_method!r}")
    method = "cubic" if interpolation is None else interpolation
    if method not in ("cubic", "linear", "nearest"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if (h, w) == img.shape[:2]:
        return img
    dt = img.dtype if img.dtype in (np.float32, np.float64) else np.float32
    x = np.asarray(img, np.float64)
    flat = x.reshape(x.shape[0], x.shape[1], -1).transpose(2, 0, 1)
    rows = resample_matrix(x.shape[0], h, method)
    cols = resample_matrix(x.shape[1], w, method)
    out = (rows @ flat @ cols.T).transpose(1, 2, 0)  # (h, w, channels)
    return out.reshape((h, w) + x.shape[2:]).astype(dt)


def _pair(v: Union[int, Sequence[int]], name: str = "value") -> Size2:
    if isinstance(v, (int, np.integer)):
        return int(v), int(v)
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return int(v[0]), int(v[1])
    raise TypeError(f"{name} must be an int or a pair of ints")


def margin_trim(img: np.ndarray, margin: Union[int, Size2]) -> np.ndarray:
    """Trim a fixed margin from both spatial borders (crop size == 0 path)."""
    m = _pair(margin, "margin")
    return img[m[0] : img.shape[0] - m[0], m[1] : img.shape[1] - m[1]]


def random_crop(
    img: np.ndarray,
    size: Union[int, Size2],
    margin: Union[int, Size2] = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random spatial crop of ``size``, keeping ``margin`` off the borders."""
    size = _pair(size, "size")
    if size == (0, 0):
        return margin_trim(img, margin)
    m = _pair(margin, "margin")
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    top = int(rng.integers(m[0], h - size[0] - m[0] + 1))
    left = int(rng.integers(m[1], w - size[1] - m[1] + 1))
    return img[top : top + size[0], left : left + size[1]]


def paired_random_crop(
    lr: np.ndarray,
    hr: np.ndarray,
    size: Union[int, Size2],
    sr_factor: int,
    margin: Union[int, Size2] = 0,
    rng: Optional[np.random.Generator] = None,
):
    """Aligned random crop of an (LR, HR) pair; ``size``/``margin`` in LR units
    (margin given in HR units, divided down as the reference does)."""
    sr_factor = int(sr_factor)
    m = tuple(v // sr_factor for v in _pair(margin, "margin"))
    size = _pair(size, "size")
    if size == (0, 0):
        return (
            lr[m[0] : lr.shape[0] - m[0], m[1] : lr.shape[1] - m[1]],
            hr[
                m[0] * sr_factor : hr.shape[0] - m[0] * sr_factor,
                m[1] * sr_factor : hr.shape[1] - m[1] * sr_factor,
            ],
        )
    rng = rng or np.random.default_rng()
    h, w = lr.shape[:2]
    # +1 on the high bound: exact-fit crops are valid (the reference's
    # SRImagePairRandomCrop raises on them — latent off-by-one, not kept)
    top = int(rng.integers(m[0], h - size[0] - m[0] + 1))
    left = int(rng.integers(m[1], w - size[1] - m[1] + 1))
    return (
        lr[top : top + size[0], left : left + size[1]],
        hr[
            top * sr_factor : (top + size[0]) * sr_factor,
            left * sr_factor : (left + size[1]) * sr_factor,
        ],
    )


def centre_crop(img: np.ndarray, size: Union[int, Size2]) -> np.ndarray:
    size = _pair(size, "size")
    h, w = img.shape[:2]
    top = max((h - size[0]) // 2, 0)
    left = max((w - size[1]) // 2, 0)
    return img[top : top + size[0], left : left + size[1]]


class ImagePadding:
    """Edge-pad images up to a target spatial size, with exact inverse.

    Padding is split ceil-before / floor-after per axis; negative padding
    (input larger than target) is clamped to zero, matching the reference.
    """

    def __init__(self, input_shape, output_shape):
        i = _pair(input_shape, "input_shape")
        o = _pair(output_shape, "output_shape")
        padding = []
        for a, b in zip(i, o):
            padding.append(math.ceil((b - a) / 2))
            padding.append(math.floor((b - a) / 2))
        self.padding = [max(p, 0) for p in padding]

    def pad(self, x: np.ndarray) -> np.ndarray:
        p = self.padding
        if x.ndim == 3:
            return np.pad(x, (p[:2], p[2:], [0, 0]), "edge")
        if x.ndim == 2:
            return np.pad(x, (p[:2], p[2:]), "edge")
        raise ValueError("pad expects a 2D or 3D array")

    def ipad(self, x: np.ndarray) -> np.ndarray:
        p = self.padding
        h, w = x.shape[:2]
        return x[p[0] : h - p[1], p[2] : w - p[3]]


def dihedral(img: np.ndarray, k: int) -> np.ndarray:
    """One of the 8 dihedral transforms (rot90 x k%4, flip if k>=4)."""
    if k >= 4:
        img = img[:, ::-1]
    return np.ascontiguousarray(np.rot90(img, k % 4))


def stack_to_nhwc(imgs: Iterable[np.ndarray]) -> np.ndarray:
    """Stack HWC images into an NHWC float32 batch (TPU-native layout)."""
    a = np.asarray(list(imgs) if not isinstance(imgs, np.ndarray) else imgs)
    if a.ndim == 3:  # N,H,W -> N,H,W,1
        a = a[..., np.newaxis]
    if a.ndim != 4:
        raise ValueError("expected a stack of HW or HWC images")
    return np.ascontiguousarray(a, dtype=np.float32)
