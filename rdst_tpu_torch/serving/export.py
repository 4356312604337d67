"""Live serving model (counterpart of ``rdst_tpu/serving/export.py``).

:class:`LiveModel` builds the generator and its trained weights from a
config, as the tester does, and answers ``predict(x, scale)`` with the
batch padded to a bucket of a sparse ladder (default 1, 8, 64), so a
server sees a few fixed batch shapes. Normalization (MeanShift) is part
of the model. ``inference_dtype = 'bfloat16'`` serves the bf16 model
(float32 parameter masters; inputs and outputs stay float32 numpy) on
the fast kernels of its kernel mode, with int8 qkv operands where
``pallas_quant='qkv'`` asks for them (modes rdstb, pair and swin). A
config with ``residual_scale > 0`` gets MetaSR's bicubic blend after the
buckets, as the JAX package applies it. The exported bundle of the JAX
package waits for a later slice; so do the other int8 groups, which
raise.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = "1,8,64"
ENV_BUCKETS = "RDST_TORCH_SERVE_BUCKETS"
_FORMAT = 1


def _canon_input(x) -> np.ndarray:
    """Accept (H,W) / (N,H,W) / (N,H,W,C); return f32 NHWC."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[..., None]
    if x.ndim != 4:
        raise ValueError(f"expected (H,W)/(N,H,W)/(N,H,W,C), got {x.shape}")
    return x


def resolve_buckets(max_batch: int, spec=None) -> Tuple[int, ...]:
    """Bucket ladder capped at (and always including) ``max_batch``.
    ``spec``: comma list ('1,8,64'), 'pow2' for the dense ladder, or
    None for the ``RDST_TORCH_SERVE_BUCKETS`` env / DEFAULT_BUCKETS."""
    max_batch = max(1, int(max_batch))
    spec = spec or os.environ.get(ENV_BUCKETS) or DEFAULT_BUCKETS
    if str(spec).strip().lower() == "pow2":
        out, b = set(), 1
        while b < max_batch:
            out.add(b)
            b *= 2
        out.add(max_batch)
        return tuple(sorted(out))
    vals = {int(v) for v in str(spec).split(",") if str(v).strip()}
    vals = {v for v in vals if 1 <= v <= max_batch}
    vals.add(max_batch)
    return tuple(sorted(vals))


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n, else the top bucket (oversized requests
    split into top-bucket chunks)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def _bucketed_predict(fn: Callable[[np.ndarray], np.ndarray], x: np.ndarray,
                      buckets: Tuple[int, ...]) -> np.ndarray:
    """Pad each chunk to its bucket (repeating the last slice), run, and
    slice the padding off."""
    n = x.shape[0]
    b = _bucket(n, buckets)
    out_chunks = []
    for i in range(0, n, b):
        blk = x[i:i + b]
        pad = b - blk.shape[0]
        if pad:
            blk = np.concatenate([blk, np.repeat(blk[-1:], pad, 0)])
        y = fn(blk)
        out_chunks.append(y[:b - pad] if pad else y)
    return np.concatenate(out_chunks, 0)


def residual_blend(out: np.ndarray, x: np.ndarray,
                   residual_scale: float) -> np.ndarray:
    """MetaSR's eval-time blend (meta_sr_trainer.py:171-172):
    ``out * (1 - r) + bicubic(x) * r``, each LR slice of ``x`` resized to
    the HR size of ``out``."""
    from rdst_tpu_torch.data import ops

    res = np.stack([
        np.asarray(ops.resize(xi, out.shape[1:3])).reshape(out.shape[1:])
        for xi in x])
    return out * (1.0 - residual_scale) + res * residual_scale


def build_serving_model(paras, device="cuda"):
    """Build the generator + trained weights exactly like the tester, on
    ``device``. Returns ``(model, meta)``; ``meta`` is the manifest
    identity (generator, scales, dtype, kernel mode, softmax variant, int8
    groups, the kernel each route unit runs...). The kernel keys are resolved once, in the
    model builder; the model keeps its mode, so another model built later
    in the process cannot change it."""
    from rdst_tpu_torch.checkpoint.loading import (load_well_trained_params,
                                                   resolve_model_path,
                                                   resolve_norm_stats)
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.models import build_generator

    dev = resolve_device(device)
    path = resolve_model_path(paras)
    idt = str(paras.get("inference_dtype", "float32")).lower()
    dtype = torch.bfloat16 if idt in ("bfloat16", "bf16") else torch.float32
    # int8 rides the bf16 fast path only (the f32 precise path drops it,
    # as the JAX precise branch does); the model factory routes it
    residual_scale = float(paras.get("residual_scale", 0.0) or 0.0)
    if not path:
        raise ValueError("no well-trained model path configured "
                         "(well_trained_single_scale_model_g)")
    mean = std = None
    norm = paras.get("normal_inputs") or ""
    if "zero_mean" in norm or "unit_std" in norm:
        mean, std = resolve_norm_stats(paras, path)
    model = build_generator(paras, mean, std, dtype=dtype)
    scales = [float(s) for s in paras.get("sr_scales_for_final_testing",
                                          paras.get("test_sr_scales"))]
    load_well_trained_params(model, paras, path, scales)
    model.to(dev).eval()
    meta = {
        "format": _FORMAT,
        "model_name": paras.get("model_name"),
        "feature_generator": str(paras.get("feature_generator")),
        "input_channel": int(paras.input_channel),
        "dtype": "bfloat16" if dtype == torch.bfloat16 else "float32",
        "layout": "NHWC",
        "scales": scales,
        "scale_free": bool(paras.get("scale_free", False)),
        "residual_scale": residual_scale,
        "pallas_kernels": model.kernel_mode or None,
        "pallas_softmax": model.softmax or None,
        "pallas_quant": sorted(model.quant) or None,
        "routes": list(model.routes),
        "device": str(dev),
        "torch_version": torch.__version__,
    }
    return model, meta


class LiveModel:
    """``predict(x, scale)`` over a live model built from a config, on
    ``device`` ('cuda' unless the caller asks for 'cpu')."""

    def __init__(self, paras, max_batch: int = 64, buckets=None,
                 device="cuda"):
        self.model, meta = build_serving_model(paras, device)
        self.device = next(self.model.parameters()).device
        self.manifest = dict(meta, entries=[])
        self.max_batch = int(max_batch)
        self.buckets = resolve_buckets(max_batch, buckets)
        self._lock = threading.Lock()  # one forward at a time on the device

    def _run(self, blk: np.ndarray) -> np.ndarray:
        with self._lock, torch.inference_mode():
            y = self.model(torch.from_numpy(blk).to(self.device))
            return y.float().cpu().numpy()

    def predict(self, x, scale: float) -> np.ndarray:
        x = _canon_input(x)
        if float(scale) not in self.manifest["scales"]:
            raise ValueError(f"scale {scale} not served; this model serves "
                             f"{self.manifest['scales']}")
        out = _bucketed_predict(self._run, x, self.buckets)
        rs = self.manifest["residual_scale"]
        return residual_blend(out, x, rs) if rs > 0 else out
