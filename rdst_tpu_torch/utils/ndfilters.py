"""The few ``scipy.ndimage`` / ``scipy.signal`` filters the port's metrics
and phantom generator use, in numpy, so that the port needs no scipy.

Each ``scipy.ndimage`` one does scipy's float64 arithmetic in scipy's
order, so that the results are the same numbers: ``correlate1d`` takes
the symmetric kernel's pairs from the outside in, ``uniform_filter1d``
keeps scipy's running sum, the multi-axis filters run axis by axis from
the first, and ``convolve`` adds the taps of the flipped kernel in C
order. ``convolve2d_valid`` sums its taps in another order than
``scipy.signal`` (a few ulp apart). Border modes are scipy's names:
'reflect' (d c b a | a b c d), 'constant' (zeros), 'nearest', 'mirror'.
"""

from __future__ import annotations

import numpy as np

_PAD_MODES = {"reflect": "symmetric", "mirror": "reflect", "nearest": "edge",
              "constant": "constant"}


def _pad_axis(x: np.ndarray, axis: int, before: int, after: int,
              mode: str) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (before, after)
    return np.pad(x, pad, mode=_PAD_MODES[mode])


def _take(x: np.ndarray, axis: int, start: int, n: int) -> np.ndarray:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, start + n)
    return x[tuple(idx)]


def correlate1d(x, weights, axis: int = -1, mode: str = "reflect"):
    """``scipy.ndimage.correlate1d`` (origin 0) for an odd symmetric or any
    kernel, in float64."""
    x = np.asarray(x, np.float64)
    w = np.asarray(weights, np.float64)
    axis = axis % x.ndim
    size = w.size
    size1 = size // 2
    size2 = size - size1 - 1
    n = x.shape[axis]
    xp = _pad_axis(x, axis, size1, size2, mode)
    symmetric = size % 2 == 1 and all(
        abs(w[size1 + i] - w[size1 - i]) <= np.finfo(np.float64).eps
        for i in range(1, size1 + 1))
    if symmetric:
        out = _take(xp, axis, size1, n) * w[size1]
        for j in range(size1, 0, -1):
            out = out + (_take(xp, axis, size1 - j, n)
                         + _take(xp, axis, size1 + j, n)) * w[size1 - j]
        return out
    out = _take(xp, axis, size1 + size2, n) * w[size1 + size2]
    for j in range(-size1, size2):
        out = out + _take(xp, axis, size1 + j, n) * w[size1 + j]
    return out


def gaussian_filter1d(x, sigma: float, axis: int = -1,
                      mode: str = "reflect", truncate: float = 4.0):
    sd = float(sigma)
    radius = int(truncate * sd + 0.5)
    t = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sd * sd) * t ** 2)
    phi = phi / phi.sum()
    return correlate1d(x, phi[::-1], axis, mode)


def gaussian_filter(x, sigma: float, mode: str = "reflect",
                    truncate: float = 4.0) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter`` (order 0, one sigma, float64)."""
    out = np.asarray(x, np.float64)
    for axis in range(out.ndim):
        out = gaussian_filter1d(out, sigma, axis, mode, truncate)
    return out


def uniform_filter1d(x, size: int, axis: int = -1, mode: str = "reflect"):
    """``scipy.ndimage.uniform_filter1d`` (origin 0) in float64: the first
    window's sum in order, then scipy's running sum, each divided by the
    size."""
    x = np.asarray(x, np.float64)
    axis = axis % x.ndim
    size1 = size // 2
    size2 = size - size1 - 1
    n = x.shape[axis]
    xp = _pad_axis(x, axis, size1, size2, mode)
    first = _take(xp, axis, 0, 1)
    for k in range(1, size):
        first = first + _take(xp, axis, k, 1)
    steps = _take(xp, axis, size, n - 1) - _take(xp, axis, 0, n - 1)
    return np.cumsum(np.concatenate([first, steps], axis=axis),
                     axis=axis) / size


def uniform_filter(x, size: int, mode: str = "reflect") -> np.ndarray:
    """``scipy.ndimage.uniform_filter`` (one size, origin 0, float64)."""
    out = np.asarray(x, np.float64)
    for axis in range(out.ndim):
        out = uniform_filter1d(out, size, axis, mode)
    return out


def convolve(x, kernel, mode: str = "constant") -> np.ndarray:
    """``scipy.ndimage.convolve`` of a 2-D float64 image with an
    odd-sized 2-D kernel: the flipped kernel's nonzero taps added in C
    order."""
    x = np.asarray(x, np.float64)
    k = np.asarray(kernel, np.float64)[::-1, ::-1]
    kh, kw = k.shape
    h, w = x.shape
    xp = np.pad(x, ((kh // 2, kh // 2), (kw // 2, kw // 2)),
                mode=_PAD_MODES[mode])
    out = np.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0:
                out = out + xp[i:i + h, j:j + w] * k[i, j]
    return out


def convolve2d_valid(x, kernel) -> np.ndarray:
    """``scipy.signal.convolve2d(x, kernel, mode='valid')`` in float64."""
    x = np.asarray(x, np.float64)
    k = np.asarray(kernel, np.float64)[::-1, ::-1]
    kh, kw = k.shape
    oh, ow = x.shape[0] - kh + 1, x.shape[1] - kw + 1
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw))[:oh, :ow]
    return np.einsum("ijkl,kl->ij", win, k)
