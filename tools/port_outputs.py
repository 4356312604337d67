"""The PyTorch port's model outputs on seeded slices, to compare two trees.

    python tools/port_outputs.py --root DIR --out outputs.npz
    python tools/port_outputs.py --compare a.npz b.npz

The first form imports ``rdst_tpu_torch`` from ``DIR`` (a checkout of any
commit of the port) and runs, on the first CUDA card, 8 LR 40x32 slices
drawn from a fixed numpy seed through each served model -- RDST-E1 in
float32 (as shipped) and in bfloat16 modes rdstb, pair and swin,
RDST-W96 in bfloat16 mode rdstb (its int8 qkv), SwinIR-std in bfloat16 as
shipped -- with the committed weights of ``DIR``, and saves the HR
outputs. The second form prints, per output, whether two such files agree
bitwise and their largest absolute difference; it exits 1 when an output
is missing from either file. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

SEED, LR_HW, SCALE = 0, (40, 32), 4.0
E1 = ("config_files/rdst_e1_40k_oasis20_x4.ini",
      "weights/rdst_e1_40k_best_oasis20_x4.msgpack")
W96 = ("config_files/rdst_w96_40k_oasis20_x4.ini",
       "weights/rdst_w96_40k_best_oasis20_x4.msgpack")
SWINIR = ("config_files/swinir_std_40k_oasis20_x4.ini",
          "weights/swinir_std_40k_best_oasis20_x4.msgpack")


def outputs(root: str) -> dict:
    """Every model's HR output on the seeded slices, from the port in
    ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)  # configs and weights by their repository paths
    import torch

    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.models.rdst import set_kernel_mode
    from rdst_tpu_torch.serving.export import LiveModel

    if not torch.cuda.is_available():
        raise SystemExit("port_outputs: needs a CUDA card")

    def live(cfg, **kw):
        p = ParametersLoader(cfg[0])
        p.set("well_trained_single_scale_model_g", cfg[1])
        for k, v in kw.items():
            p.set(k, v)
        return LiveModel(p, max_batch=8, device="cuda")

    x = np.random.default_rng(SEED).random((8,) + LR_HW + (1,),
                                           dtype=np.float32)
    out = {"e1_f32": live(E1).predict(x, SCALE)}
    e1 = live(E1, inference_dtype="bfloat16")
    for mode in ("rdstb", "pair", "swin"):
        set_kernel_mode(e1.model, mode, e1.model.softmax)
        out[f"e1_bf16_{mode}"] = e1.predict(x, SCALE)
    out["w96_bf16_rdstb"] = live(W96, inference_dtype="bfloat16").predict(
        x, SCALE)
    out["swinir_std_bf16"] = live(SWINIR).predict(x, SCALE)
    return {k: np.asarray(v) for k, v in out.items()}


def compare(a: str, b: str) -> int:
    fa, fb = np.load(a), np.load(b)
    missing = sorted(set(fa.files) ^ set(fb.files))
    for k in sorted(set(fa.files) & set(fb.files)):
        d = float(np.abs(fa[k].astype(np.float64)
                         - fb[k].astype(np.float64)).max())
        same = np.array_equal(fa[k], fb[k])
        print(f"{k}: {'bitwise equal' if same else 'differs'} (max abs "
              f"difference {d:.3e})")
    for k in missing:
        print(f"{k}: in one file only")
    return 1 if missing else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="the checkout whose port runs")
    ap.add_argument("--out", help="where its outputs go (.npz)")
    ap.add_argument("--compare", nargs=2, metavar="NPZ",
                    help="compare two output files")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not (args.root and args.out):
        ap.error("--root and --out, or --compare")
    out = os.path.abspath(args.out)
    np.savez(out, **outputs(args.root))
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
