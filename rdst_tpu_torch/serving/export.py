"""Live serving model (counterpart of ``rdst_tpu/serving/export.py``).

:class:`LiveModel` builds the generator and its trained weights from a
config, as the tester does, and answers ``predict(x, scale)`` with the
batch padded to a bucket of a sparse ladder (default 1, 8, 64), so a
server sees a few fixed batch shapes. The model is called at the
requested scale (read by scale-free models: MetaSR, a scale-free RDST;
the manifest lists the scales served, fractional ones included).
Normalization (MeanShift) is part of the model. ``inference_dtype = 'bfloat16'`` serves the bf16 model
(float32 parameter masters; inputs and outputs stay float32 numpy) on
the fast kernels of its kernel mode, with int8 qkv operands where
``pallas_quant='qkv'`` asks for them (modes rdstb, pair and swin). A
config with ``residual_scale > 0`` gets MetaSR's bicubic blend after the
buckets, as the JAX package applies it. The exported bundle of the JAX
package waits for a later slice.

On the config's data axis (``mesh_shape``, :mod:`rdst_tpu_torch.
parallel`; every visible GPU by default) the live model holds one replica
on each device: each bucket is rounded up to a multiple of the axis (the
JAX ``min_bucket``), split into equal shards that run on their devices,
and the outputs are gathered on the host. The manifest's ``mesh`` entry is
the JAX one (``{"data": N}``).
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
                      buckets: Tuple[int, ...],
                      min_bucket: int = 1) -> np.ndarray:
    """Pad each chunk to its bucket (repeating the last slice), run, and
    slice the padding off. The bucket is rounded up to a multiple of
    ``min_bucket`` (the data axis), so that it splits into equal shards."""
    n = x.shape[0]
    b = -(-_bucket(n, buckets) // min_bucket) * min_bucket
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


def _check_servable(paras) -> None:
    """Refuse, at load, the generators that the JAX server would fail to
    apply to the slices it is sent, naming the key to set: ZSSR maps an
    input already interpolated to the output size (served from a config
    with ``lr_image_size_remain = True``, its clients send the HR-size
    slice; so does SwinIR's denoise head, ``sir_upsampler = ''``, which
    returns its input's size), IPT runs only at its training patch (served
    from a config with ``tiled_inference = True``, its clients send
    patch-size tiles)."""
    name = str(paras.get("feature_generator")
               or paras.get("sr_generator")).strip().lower()
    if name == "zssr" and not paras.get("lr_image_size_remain"):
        raise ValueError(
            "ZSSR does not upsample: it maps a slice already interpolated "
            "to the output size. Serve it from a config with "
            "lr_image_size_remain = True and send HR-size slices")
    if name in ("swinir", "swin") and paras.get("sir_upsampler") == "" \
            and not paras.get("lr_image_size_remain"):
        raise ValueError(
            "SwinIR's denoise head (sir_upsampler = '') returns its input's "
            "size: it maps a slice already interpolated to the output size. "
            "Serve it from a config with lr_image_size_remain = True and "
            "send HR-size slices")
    if name == "ipt" and not paras.get("tiled_inference"):
        p = int(paras.patch_size)
        raise ValueError(
            f"IPT runs only at its training patch ({p}x{p}). Serve it from "
            "a config with tiled_inference = True and send "
            f"{p}x{p} tiles")


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
    _check_servable(paras)
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
    ``device`` ('cuda' unless the caller asks for 'cpu'): on the config's
    data axis there, or on an explicit ``devices`` list."""

    def __init__(self, paras, max_batch: int = 64, buckets=None,
                 device="cuda", devices=None):
        from rdst_tpu_torch.parallel.mesh import (data_mesh_from_paras,
                                                  replicate_module)

        self.mesh = data_mesh_from_paras(paras, device, devices)
        if self.mesh.distributed:
            raise ValueError("the live model is one process over the data "
                             "axis: start it outside a process group")
        self.model, meta = build_serving_model(paras, self.mesh.device)
        self.replicas = replicate_module(self.model, self.mesh.devices)
        self.device = next(self.model.parameters()).device
        self.manifest = dict(meta, entries=[], mesh={
            k: int(v) for k, v in self.mesh.shape.items()})
        self.max_batch = int(max_batch)
        self.buckets = resolve_buckets(max_batch, buckets)
        self._lock = threading.Lock()  # one bucket forward at a time

    def _run(self, blk: np.ndarray, scale=None) -> np.ndarray:
        """One padded bucket through the replicas at ``scale`` (read by a
        scale-free model only, which needs it), a shard each."""
        from rdst_tpu_torch.parallel.mesh import data_parallel

        fns = [lambda s, m=m: m(s, scale) for m in self.replicas]
        with self._lock, torch.inference_mode():
            return data_parallel(self.mesh, fns, blk).float().cpu().numpy()

    def predict(self, x, scale: float) -> np.ndarray:
        """The model at ``scale`` (one of the manifest's) on each slice,
        as the JAX ``LiveModel`` calls it: a scale-free model's output is
        ``int(scale * size)`` a side."""
        x = _canon_input(x)
        scale = float(scale)
        if scale not in self.manifest["scales"]:
            raise ValueError(f"scale {scale} not served; this model serves "
                             f"{self.manifest['scales']}")
        out = _bucketed_predict(lambda blk: self._run(blk, scale), x,
                                self.buckets, self.mesh.size)
        rs = self.manifest["residual_scale"]
        return residual_blend(out, x, rs) if rs > 0 else out
