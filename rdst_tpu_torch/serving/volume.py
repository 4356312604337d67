"""Whole-volume SR: NIfTI in, super-resolved NIfTI out (counterpart of
``rdst_tpu/serving/volume.py``).

In-plane 2D SR per slice along a chosen axis:

    python -m rdst_tpu_torch.serving.volume --config-file X.ini \
        --in brain.nii.gz --out brain_x4.nii.gz --scale 4

(or ``--bundle DIR`` for an exported bundle, ``--url`` for a running
server).

Intensities are min/max-normalized to [0,1] for the network (the
training-corpus convention, OASIS_dataset.py:86-90) and mapped back to
the input range on the way out.
"""

from __future__ import annotations

import numpy as np


def sr_volume(predictor, vol: np.ndarray, scale: float,
              axis: int = 2) -> np.ndarray:
    """SR every slice of ``vol`` along ``axis`` (in-plane 2D).

    ``predictor`` is a :class:`~rdst_tpu_torch.serving.LiveModel`, a
    :class:`~rdst_tpu_torch.serving.ServingBundle` or an HTTP
    :class:`~rdst_tpu_torch.serving.client.SRClient`. Returns the volume
    with both in-plane dims scaled by ``scale``; intensities are restored
    to the input range. Non-finite values are rejected.
    """
    vol = np.asarray(vol, np.float32)
    if vol.ndim != 3:
        raise ValueError(f"expected a 3-D volume, got shape {vol.shape}")
    if not np.isfinite(vol).all():
        raise ValueError("volume contains non-finite values")
    vol = np.moveaxis(vol, axis, 0)  # (Z, H, W)

    lo, hi = float(vol.min()), float(vol.max())
    den = (hi - lo) or 1.0
    x = (vol[..., None] - lo) / den  # (Z, H, W, 1) in [0, 1]

    out = np.asarray(predictor.predict(x, float(scale)))
    out = np.clip(out[..., 0], 0.0, 1.0) * den + lo
    return np.moveaxis(out, 0, axis)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="super-resolve a NIfTI/Analyze volume")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", help="serving bundle dir written by "
                     "python -m rdst_tpu_torch.serving.export")
    src.add_argument("--config-file", help="live model from a config")
    src.add_argument("--url", help="running server, e.g. "
                     "http://host:8000 (no local model needed)")
    ap.add_argument("--in", dest="inp", required=True,
                    help="input .nii[.gz] / .hdr / .img")
    ap.add_argument("--out", required=True, help="output volume path")
    ap.add_argument("--scale", type=float, default=4.0)
    ap.add_argument("--axis", type=int, default=2,
                    help="slice axis (default 2, the reference's)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="device of the bundle or live model (default: "
                    "cuda)")
    args = ap.parse_args(argv)

    if args.url:
        from rdst_tpu_torch.serving.client import SRClient

        predictor = SRClient(args.url)
    elif args.bundle:
        from rdst_tpu_torch.serving.export import ServingBundle

        predictor = ServingBundle.load(args.bundle, max_batch=args.max_batch,
                                       device=args.platform or "cuda")
    else:
        from rdst_tpu_torch.config import ParametersLoader
        from rdst_tpu_torch.serving.export import LiveModel

        predictor = LiveModel(ParametersLoader(args.config_file),
                              max_batch=args.max_batch,
                              device=args.platform or "cuda")

    from rdst_tpu_torch.data import io

    vol = io.load(args.inp).get_fdata().astype(np.float32)
    out = sr_volume(predictor, vol, args.scale, axis=args.axis)
    io.save(args.out, out.astype(np.float32))
    print(f"{args.inp} {vol.shape} -> {args.out} {out.shape}")


if __name__ == "__main__":
    main()
