"""The JAX tester's own numbers for the tester rows of ``chip_smoke.py``
(its ``TESTER_BARS``), on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_tester_bars.py [--data DIR] [ROW ...]

Makes the seeded 20-phantom corpus with ``rdst_tpu.data.synthetic`` (the
corpus ``chip_smoke.py`` makes with the port's generator) unless
``--data`` names one, then scores each row with
``rdst_tpu.runners.tester.SRTester`` on patients 19-20, each row in a
fresh process: the JAX package's kernel flags are process-wide
environment variables, so a config's ``pallas_quant`` would leak into the
next one. Rows marked ``interpret`` run the JAX package's Pallas kernels
in interpret mode (``RDST_TPU_PALLAS_INTERPRET=1``), the kernels'
numerics as on a TPU; without it the JAX package runs plain XLA bf16 on
the CPU. Prints one JSON line a row: its mean scores over the slices.
Run it from the repo root: ``lpips`` finds its VGG weights relative to
the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
E1 = ("config_files/rdst_e1_40k_oasis20_x4.ini",
      "weights/rdst_e1_40k_best_oasis20_x4.msgpack")
W96 = ("config_files/rdst_w96_40k_oasis20_x4.ini",
       "weights/rdst_w96_40k_best_oasis20_x4.msgpack")
# name: (config, weights, overrides, interpret)
ROWS = {
    "bicubic": (E1[0], None, {"feature_generator": "bicubic"}, False),
    "E1 f32": (*E1, {}, False),
    "E1 bf16": (*E1, {"inference_dtype": "bfloat16"}, True),
    "E1 f32 tiled": (*E1, {"tiled_inference": True,
                           "test_lr_patch_stride": 12}, False),
    "E1 f32 tiled 12/6": (*E1, {"tiled_inference": True, "patch_size": 12,
                                "test_lr_patch_stride": 6}, False),
    "HRL fine-tune": ("config_files/rdst_hrl_seg_ft_oasis20_x4.ini",
                      "weights/rdst_hrl_ft_best_oasis20_x4.msgpack", {},
                      False),
    "RaGAN fine-tune 5k": ("config_files/rdst_gan_ft_oasis20_x4.ini",
                           "weights/rdst_ganft_5k_best_oasis20_x4.msgpack",
                           {}, False),
    "RaGAN fine-tune 2 10k": (
        "config_files/rdst_gan_ft2_oasis20_x4.ini",
        "weights/rdst_ganft2_10k_best_oasis20_x4.msgpack", {}, False),
    "SwinIR-light": ("config_files/swinir_light_40k_oasis20_x4.ini",
                     "weights/swinir_light_40k_best_oasis20_x4.msgpack", {},
                     False),
    "SwinIR-std": ("config_files/swinir_std_40k_oasis20_x4.ini",
                   "weights/swinir_std_40k_best_oasis20_x4.msgpack", {},
                   True),
    "W96 f32": (*W96, {}, False),
    "W96 bf16": (*W96, {"inference_dtype": "bfloat16"}, True),
    "W96 bf16 XLA": (*W96, {"inference_dtype": "bfloat16"}, False),
}


def score(name: str, data: str, out: str) -> dict:
    """One row through the JAX tester in this process."""
    import numpy as np

    from rdst_tpu.config import ParametersLoader
    from rdst_tpu.runners.tester import SRTester

    config, weights, overrides, _ = ROWS[name]
    p = ParametersLoader(os.path.join(REPO, config))
    p.set("data_folder", data)
    p.set("output_dir", out)
    p.set("verbose", False)
    if weights:
        p.set("well_trained_single_scale_model_g",
              os.path.join(REPO, weights))
    for k, v in overrides.items():
        p.set(k, v)
    tester = SRTester(p)
    tester.setup()
    stacked = tester.test()
    return {m.rsplit("_", 1)[0]: float(np.mean(v)) for m, v in stacked.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help=f"rows (default all): {list(ROWS)}")
    ap.add_argument("--data", default=None, help="an OASIS example20 corpus")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps({"row": args.one,
                          **score(args.one, args.data, args.out)}),
              flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data
        if data is None:
            from rdst_tpu.data import synthetic

            data = os.path.join(tmp, "OASIS", "example20")
            synthetic.make_oasis_example(
                data, patient_ids=tuple(f"OAS1_{i:04d}_MR1"
                                        for i in range(1, 21)))
        for name in args.rows or ROWS:
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       RDST_TPU_PALLAS_INTERPRET="1" if ROWS[name][3]
                       else "0")
            out = os.path.join(tmp, "out", name.replace(" ", "_"))
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", name,
                 "--data", data, "--out", out],
                env=env, capture_output=True, text=True, check=False)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")]
            if proc.returncode or not lines:
                print(proc.stderr[-2000:], file=sys.stderr)
                return 1
            print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
