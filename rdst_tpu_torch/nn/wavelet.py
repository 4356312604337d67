"""2D discrete wavelet transform, periodized (the port's own copy of
``rdst_tpu/nn/wavelet.py``).

Per axis, analysis is a circularly padded, strided, depthwise correlation
(exactly n/2 coefficients a band) and synthesis its adjoint, a
transposed convolution with the same filter plus a circular fold of the
overhang: perfect reconstruction for the orthogonal ``haar`` / ``db1``
and ``db2`` on even sizes. Tensors are NHWC, as in the JAX package; the
products run as ``F.conv2d(groups=C)`` / ``F.conv_transpose2d`` (the JAX
package computes them in XLA). On bf16 input the filters are rounded to
bf16, the sums taken in float32 and each convolution's output rounded to
bf16, as a bf16 XLA convolution does; the fold adds in bf16.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

_SQRT2 = math.sqrt(2.0)
_WAVELETS = {
    "haar": np.array([1.0, 1.0]) / _SQRT2,
    "db1": np.array([1.0, 1.0]) / _SQRT2,
    "db2": np.array([
        0.48296291314469025, 0.836516303737469,
        0.22414386804185735, -0.12940952255092145,
    ]),
}


def filters(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(decomposition low-pass, high-pass) of wavelet ``name``."""
    if name not in _WAVELETS:
        raise ValueError(f"wavelet {name!r}: expected one of "
                         f"{sorted(_WAVELETS)}")
    base = _WAVELETS[name]
    dec_lo = base[::-1].copy()
    dec_hi = np.array([(-1) ** k for k in range(len(base))]) * base
    return dec_lo, dec_hi


def _kernel(filt: np.ndarray, x: torch.Tensor, axis: int) -> torch.Tensor:
    """The 1D filter as a (1, 1, k, 1) or (1, 1, 1, k) conv weight, in
    x's dtype rounded (bf16 filters for bf16 input) and computed in f32."""
    k = torch.as_tensor(filt, dtype=x.dtype).float().to(x.device)
    return k.reshape((1, 1, -1, 1) if axis == 1 else (1, 1, 1, -1))


def _ana1d(x: torch.Tensor, filt: np.ndarray, axis: int) -> torch.Tensor:
    """Strided circular correlation along spatial axis 1 (H) or 2 (W) of
    NHWC ``x``."""
    k = len(filt)
    if k > 2:
        pad = k - 2
        x = torch.cat([x, x[:, :pad] if axis == 1 else x[:, :, :pad]], axis)
    n, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2).float()
    wt = _kernel(filt, x, axis).expand(c, 1, -1, -1)
    stride = (2, 1) if axis == 1 else (1, 2)
    y = F.conv2d(xc, wt, stride=stride, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _syn1d(c: torch.Tensor, filt: np.ndarray, axis: int,
           out_size: int) -> torch.Tensor:
    """Adjoint of :func:`_ana1d`: scatter by the transposed conv, then
    fold the overhang circularly onto the start."""
    k = len(filt)
    n, hh, ww, ch = c.shape
    cc = c.permute(0, 3, 1, 2).float()
    wt = _kernel(filt, c, axis).expand(ch, 1, -1, -1)
    stride = (2, 1) if axis == 1 else (1, 2)
    y = F.conv_transpose2d(cc, wt, stride=stride, groups=ch).to(c.dtype)
    if k > 2:
        pad = k - 2
        if axis == 1:
            head = y[:, :, :pad] + y[:, :, out_size:out_size + pad]
            y = torch.cat([head, y[:, :, pad:out_size]], 2)
        else:
            head = y[..., :pad] + y[..., out_size:out_size + pad]
            y = torch.cat([head, y[..., pad:out_size]], 3)
    return y.permute(0, 2, 3, 1)


def dwt2(x: torch.Tensor, wavelet: str = "haar"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-level 2D DWT (periodization) of NHWC input with even H, W.

    Returns (ll (N, H/2, W/2, C), bands (N, H/2, W/2, C, 3) = LH, HL,
    HH)."""
    lo, hi = filters(wavelet)
    lo_r = _ana1d(x, lo, 1)
    hi_r = _ana1d(x, hi, 1)
    ll = _ana1d(lo_r, lo, 2)
    lh = _ana1d(lo_r, hi, 2)
    hl = _ana1d(hi_r, lo, 2)
    hh = _ana1d(hi_r, hi, 2)
    return ll, torch.stack([lh, hl, hh], dim=-1)


def idwt2(ll: torch.Tensor, bands: torch.Tensor,
          wavelet: str = "haar") -> torch.Tensor:
    """Inverse of :func:`dwt2` (exact for orthogonal wavelets)."""
    lo, hi = filters(wavelet)
    lh, hl, hh = bands[..., 0], bands[..., 1], bands[..., 2]
    w_out, h_out = 2 * ll.shape[2], 2 * ll.shape[1]
    lo_r = _syn1d(ll, lo, 2, w_out) + _syn1d(lh, hi, 2, w_out)
    hi_r = _syn1d(hl, lo, 2, w_out) + _syn1d(hh, hi, 2, w_out)
    return _syn1d(lo_r, lo, 1, h_out) + _syn1d(hi_r, hi, 1, h_out)


def wavedec2(x: torch.Tensor, wavelet: str = "haar", level: int = 1):
    """Multi-level DWT: (ll, [bands of level 1, ..., level L])."""
    coeffs: List[torch.Tensor] = []
    ll = x
    for _ in range(level):
        ll, bands = dwt2(ll, wavelet)
        coeffs.append(bands)
    return ll, coeffs


def waverec2(ll: torch.Tensor, coeffs, wavelet: str = "haar") -> torch.Tensor:
    """Inverse of :func:`wavedec2`."""
    for bands in reversed(coeffs):
        ll = idwt2(ll, bands, wavelet)
    return ll
