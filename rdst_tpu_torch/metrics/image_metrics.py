"""Full-reference image quality metrics (numpy, host-side): the port's
own copy of ``rdst_tpu/metrics/image_metrics.py``.

Native implementations of the metric set the reference exposes through
skimage + sewar (upstream metrics/sr_metrics.py:8-13,36-45):
psnr, ssim, mse, rmse, rmse_sw, uqi, ergas, scc, rase, sam, vifp, psnrb.
Neither library is a dependency here; psnr/ssim follow skimage's
documented algorithm (data_range semantics, win_size=7 uniform-filter
SSIM with sample covariance), the rest follow the published formulas the
sewar package implements.

All functions take (gt, pred) HxW or HxWxC float arrays and treat
multi-channel images by averaging per-channel scores (sewar convention).
"""

from __future__ import annotations

import numpy as np
from rdst_tpu_torch.utils.ndfilters import uniform_filter

EPS = np.finfo(np.float64).eps


def _as_f64(gt, p):
    gt = np.asarray(gt, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    if gt.shape != p.shape:
        raise ValueError(f"shape mismatch: {gt.shape} vs {p.shape}")
    return gt, p


def _bands(x):
    return x[..., None] if x.ndim == 2 else x


# -- core ---------------------------------------------------------------------

def mse(gt, p):
    gt, p = _as_f64(gt, p)
    return float(np.mean((gt - p) ** 2))


def rmse(gt, p):
    return float(np.sqrt(mse(gt, p)))


def psnr(gt, p, data_range: float = 1.0):
    """skimage.metrics.peak_signal_noise_ratio with explicit data_range."""
    err = mse(gt, p)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / err))


def _ssim_single(gt, p, data_range, win_size):
    """skimage structural_similarity: uniform filter, sample covariance."""
    nd = gt.ndim
    n = win_size**nd
    cov_norm = n / (n - 1)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    ux = uniform_filter(gt, win_size)
    uy = uniform_filter(p, win_size)
    uxx = uniform_filter(gt * gt, win_size)
    uyy = uniform_filter(p * p, win_size)
    uxy = uniform_filter(gt * p, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux**2 + uy**2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return s[tuple(slice(pad, dim - pad) for dim in s.shape)].mean()


def ssim(gt, p, data_range: float = 1.0, win_size: int = 7):
    """Channel-averaged SSIM (skimage multichannel=True semantics)."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    vals = [_ssim_single(gt[..., c], p[..., c], data_range, win_size) for c in range(gt.shape[-1])]
    return float(np.mean(vals))


# -- sliding-window family ----------------------------------------------------

def _rmse_sw_single(gt, p, ws):
    errors = uniform_filter((gt - p) ** 2, ws)
    rmse_map = np.sqrt(np.maximum(errors, 0))
    s = int(np.round(ws / 2))
    return np.mean(rmse_map[s:-s, s:-s]), rmse_map


def rmse_sw(gt, p, ws: int = 8):
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    vals = [_rmse_sw_single(gt[..., c], p[..., c], ws)[0] for c in range(gt.shape[-1])]
    return float(np.mean(vals))


def _uqi_single(gt, p, ws):
    n = ws * ws
    s_gt = uniform_filter(gt, ws) * n
    s_p = uniform_filter(p, ws) * n
    s_gtgt = uniform_filter(gt * gt, ws) * n
    s_pp = uniform_filter(p * p, ws) * n
    s_gtp = uniform_filter(gt * p, ws) * n

    mul_means = s_gt * s_p
    sum_sq_means = s_gt * s_gt + s_p * s_p
    num = 4 * (n * s_gtp - mul_means) * mul_means
    den1 = n * (s_gtgt + s_pp) - sum_sq_means
    den = den1 * sum_sq_means

    q = np.ones_like(den)
    idx = np.logical_and(den1 == 0, sum_sq_means != 0)
    q[idx] = 2 * mul_means[idx] / sum_sq_means[idx]
    idx = den != 0
    q[idx] = num[idx] / den[idx]
    s = (ws - 1) // 2
    return np.mean(q[s : q.shape[0] - s, s : q.shape[1] - s])


def uqi(gt, p, ws: int = 8):
    """Universal Quality Index (Wang & Bovik 2002)."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    vals = [_uqi_single(gt[..., c], p[..., c], ws) for c in range(gt.shape[-1])]
    return float(np.mean(vals))


def ergas(gt, p, r: int = 4, ws: int = 8):
    """Relative dimensionless global error (per-window form)."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    nb = gt.shape[-1]
    acc = None
    for c in range(nb):
        _, rm = _rmse_sw_single(gt[..., c], p[..., c], ws)
        means = uniform_filter(gt[..., c], ws)
        bad = means == 0
        means = np.where(bad, 1.0, means)
        rm = np.where(bad, 0.0, rm)
        term = (rm**2) / (means**2)
        acc = term if acc is None else acc + term
    emap = 100 * r * np.sqrt(acc / nb)
    s = int(np.round(ws / 2))
    return float(np.mean(emap[s:-s, s:-s]))


def rase(gt, p, ws: int = 8):
    """Relative average spectral error."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    nb = gt.shape[-1]
    acc = None
    for c in range(nb):
        _, rm = _rmse_sw_single(gt[..., c], p[..., c], ws)
        term = rm**2
        acc = term if acc is None else acc + term
    gmean = uniform_filter(gt.mean(-1), ws)
    rase_map = (100.0 / np.maximum(gmean, EPS)) * np.sqrt(acc / nb)
    s = int(np.round(ws / 2))
    return float(np.mean(rase_map[s:-s, s:-s]))


def _scc_filter(x):
    # high-pass Laplacian (as used by the spatial correlation coefficient)
    from rdst_tpu_torch.utils.ndfilters import convolve

    k = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=np.float64)
    return convolve(x, k, mode="constant")


def scc(gt, p, ws: int = 8):
    """Spatial correlation coefficient of high-pass filtered images."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    vals = []
    for c in range(gt.shape[-1]):
        a = _scc_filter(gt[..., c])
        b = _scc_filter(p[..., c])
        mu_a, mu_b = uniform_filter(a, ws), uniform_filter(b, ws)
        va = uniform_filter(a * a, ws) - mu_a**2
        vb = uniform_filter(b * b, ws) - mu_b**2
        vab = uniform_filter(a * b, ws) - mu_a * mu_b
        den = np.sqrt(np.maximum(va, 0)) * np.sqrt(np.maximum(vb, 0))
        cmap = np.where(den != 0, vab / np.maximum(den, EPS), 0.0)
        vals.append(np.mean(cmap))
    return float(np.mean(vals))


def sam(gt, p):
    """Spectral angle mapper, radians (0 = identical spectra)."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    dot = np.sum(gt * p, axis=-1)
    na = np.sqrt(np.sum(gt * gt, axis=-1))
    nb = np.sqrt(np.sum(p * p, axis=-1))
    cos = dot / np.maximum(na * nb, EPS)
    valid = (na * nb) > 0
    ang = np.arccos(np.clip(cos, -1, 1))
    return float(np.mean(ang[valid])) if valid.any() else 0.0


def _fspecial_gauss(n: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian') as sewar's utils.fspecial builds it:
    an n-tap truncated window, sub-eps taps zeroed, normalized."""
    x, y = np.mgrid[-(n // 2):n - n // 2, -(n // 2):n - n // 2]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    s = g.sum()
    return g / s if s != 0 else g


def _vifp_single(gt, p, sigma_nsq=2.0):
    """Exact sewar algorithm (full_ref.vifp / the original VIF MATLAB
    code): N = 2^(4-scale+1)+1 tap window with sigma N/5, 'valid'
    convolutions, 1e-10 thresholds, num/den without an extra eps."""
    from rdst_tpu_torch.utils.ndfilters import convolve2d_valid

    eps = 1e-10
    num, den = 0.0, 0.0
    for scale in range(1, 5):
        n = int(2 ** (4 - scale + 1) + 1)
        win = _fspecial_gauss(n, n / 5.0)
        if scale > 1:
            if min(gt.shape) < n or (min(gt.shape) - n + 1 + 1) // 2 < n:
                break  # image exhausted: smaller slices keep the scales
                # that fit (sewar itself crashes here; identical numbers
                # wherever all four scales run)
            gt = convolve2d_valid(gt, win)[::2, ::2]
            p = convolve2d_valid(p, win)[::2, ::2]
        elif min(gt.shape) < n:
            break
        mu1 = convolve2d_valid(gt, win)
        mu2 = convolve2d_valid(p, win)
        mu1_sq, mu2_sq, mu1mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = convolve2d_valid(gt * gt, win) - mu1_sq
        s2 = convolve2d_valid(p * p, win) - mu2_sq
        s12 = convolve2d_valid(gt * p, win) - mu1mu2
        s1 = np.maximum(s1, 0)
        s2 = np.maximum(s2, 0)
        g = s12 / (s1 + eps)
        sv = s2 - g * s12
        g[s1 < eps] = 0
        sv[s1 < eps] = s2[s1 < eps]
        s1 = np.where(s1 < eps, 0, s1)
        g[s2 < eps] = 0
        sv[s2 < eps] = 0
        sv[g < 0] = s2[g < 0]
        g = np.maximum(g, 0)
        sv = np.maximum(sv, eps)
        num += np.sum(np.log10(1 + g * g * s1 / (sv + sigma_nsq)))
        den += np.sum(np.log10(1 + s1 / sigma_nsq))
    return float(num / den) if den != 0 else float("nan")


def vifp(gt, p):
    """Visual information fidelity, pixel domain (Sheikh & Bovik)."""
    gt, p = _as_f64(gt, p)
    gt, p = _bands(gt), _bands(p)
    vals = [_vifp_single(gt[..., c], p[..., c]) for c in range(gt.shape[-1])]
    return float(np.mean(vals))


def _blocking_effect_factor(im, block_size=8):
    h, w = im.shape
    h_idx = np.arange(block_size - 1, h - 1, block_size)
    w_idx = np.arange(block_size - 1, w - 1, block_size)

    d_b = d_bc = 0.0
    n_b = n_bc = 0
    # horizontal neighbor diffs
    diffs = (im[:, :-1] - im[:, 1:]) ** 2
    mask = np.zeros(w - 1, dtype=bool)
    mask[w_idx[w_idx < w - 1]] = True
    d_b += diffs[:, mask].sum()
    d_bc += diffs[:, ~mask].sum()
    n_b += mask.sum() * h
    n_bc += (~mask).sum() * h
    # vertical neighbor diffs
    diffs = (im[:-1, :] - im[1:, :]) ** 2
    mask = np.zeros(h - 1, dtype=bool)
    mask[h_idx[h_idx < h - 1]] = True
    d_b += diffs[mask, :].sum()
    d_bc += diffs[~mask, :].sum()
    n_b += mask.sum() * w
    n_bc += (~mask).sum() * w

    d_b /= max(n_b, 1)
    d_bc /= max(n_bc, 1)
    t = np.log2(block_size) / np.log2(min(h, w)) if d_b > d_bc else 0.0
    return t * (d_b - d_bc)


def psnrb(gt, p, data_range: float = 1.0):
    """PSNR-B: PSNR with a blocking-effect penalty on the prediction."""
    gt, p = _as_f64(gt, p)
    gt2 = _bands(gt)
    p2 = _bands(p)
    total = 0.0
    for c in range(gt2.shape[-1]):
        err = np.mean((gt2[..., c] - p2[..., c]) ** 2)
        bef = _blocking_effect_factor(p2[..., c])
        mse_b = err + bef
        total += float("inf") if mse_b == 0 else 10 * np.log10(data_range**2 / mse_b)
    return float(total / gt2.shape[-1])


def dice_coefficient(gt_label, pred_label, n_classes=None):
    """Per-class Dice: 2|A∩B| / (|A|+|B|), reference seg_evaluation.py:44-54."""
    gt_label = np.asarray(gt_label)
    pred_label = np.asarray(pred_label)
    if n_classes is None:
        n_classes = int(max(gt_label.max(), pred_label.max())) + 1
    scores = []
    for cls in range(n_classes):
        a = gt_label == cls
        b = pred_label == cls
        denom = a.sum() + b.sum()
        scores.append(1.0 if denom == 0 else 2.0 * np.logical_and(a, b).sum() / denom)
    return np.array(scores)


def lpips(gt, p) -> float:
    """LPIPS-style perceptual distance over the committed VGG feature
    stack (``metrics/perceptual.py``; imported here on first use, so the
    backbone loads only when a config asks for the metric). Lower is
    better; comparable within this repo."""
    from rdst_tpu_torch.metrics.perceptual import lpips as _lpips

    return _lpips(gt, p)


METRIC_FUNCS = {
    "mse": mse,
    "rmse": rmse,
    "psnr": psnr,
    "ssim": ssim,
    "rmse_sw": rmse_sw,
    "uqi": uqi,
    "ergas": ergas,
    "scc": scc,
    "rase": rase,
    "sam": sam,
    "vifp": vifp,
    "psnrb": psnrb,
    "lpips": lpips,
}
