"""The JAX tester's own numbers for the tester rows of ``chip_smoke.py``
(its ``TESTER_BARS`` and ``DICE_BARS``), on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_tester_bars.py [--data DIR] [--dice]
        [ROW ...]

Makes the seeded 20-phantom corpus with ``rdst_tpu.data.synthetic`` (the
corpus ``chip_smoke.py`` makes with the port's generator) unless
``--data`` names one, and for the cross-dataset rows (``BraTS``,
``ACDC``, ``COVID``: the committed 10k snapshots on their 8-phantom
corpora, test patient 8) that dataset's corpus beside it, then scores
each row with ``rdst_tpu.runners.tester.SRTester`` on the config's
testing patients (OASIS 19-20), each row in a
fresh process: the JAX package's kernel flags are process-wide
environment variables, so a config's ``pallas_quant`` would leak into the
next one. A row of a config with several test scales (MetaSR) keys its
scores by scale (``psnr_1.5``, ...), a BraTS row by modality
(``{"t1ce": {"psnr": ..., "ssim": ...}, ...}``). With ``--dice`` each
row (default: the rows of ``DICE_ROWS``) is scored, then its saved SR
volumes go through ``rdst_tpu.runners.seg_eval`` with the committed
``weights/unet_tiny.pkl``: the row's ``dice`` is the per-class mean over
the testing patients. Rows marked ``interpret`` run the JAX package's Pallas kernels
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
    # every int8 group (pallas_quant = 'all') in the bf16 kernels
    "E1 bf16 int8 all": (*E1, {"inference_dtype": "bfloat16",
                               "pallas_quant": "all"}, True),
    "W96 bf16 int8 all": (*W96, {"inference_dtype": "bfloat16",
                                 "pallas_quant": "all"}, True),
    "SwinIR-std int8 all": ("config_files/swinir_std_40k_oasis20_x4.ini",
                            "weights/swinir_std_40k_best_oasis20_x4.msgpack",
                            {"pallas_quant": "all"}, True),
    # one model at the four scales of its config: a score a scale
    "MetaSR": ("config_files/metasr_20k_oasis20_x4.ini",
               "weights/metasr_20k_best_oasis20_x4.msgpack", {}, False),
    # the cross-dataset layouts, f32 as shipped
    "BraTS": ("config_files/rdst_e1_10k_brats8_x4.ini",
              "weights/rdst_e1_10k_brats8_best_x4.msgpack", {}, False),
    "ACDC": ("config_files/rdst_e1_10k_acdc8_x4.ini",
             "weights/rdst_e1_10k_acdc8_best_x4.msgpack", {}, False),
    "COVID": ("config_files/rdst_e1_10k_covid8_x4.ini",
              "weights/rdst_e1_10k_covid8_best_x4.msgpack", {}, False),
}
# the rows with a Dice entry in the README's model table
DICE_ROWS = ("bicubic", "E1 f32", "HRL fine-tune", "SwinIR-light",
             "SwinIR-std", "W96 f32")
UNET = "weights/unet_tiny.pkl"
# dataset: (maker, id format); the 8-phantom corpora at their default sizes
XDATA = {"BraTS": ("make_brats_example", "HGG_Brats17_SYN_{:03d}_1"),
         "ACDC": ("make_acdc_example", "patient{:03d}"),
         "COVID": ("make_covid_example", "volume-covid19-A-{:04d}")}


def dataset_of(config: str) -> str:
    """'OASIS', 'BraTS', 'ACDC' or 'COVID': the dataset a config's
    ``data_folder`` names."""
    from rdst_tpu.config import ParametersLoader

    folder = ParametersLoader(os.path.join(REPO, config)).data_folder
    return next(d for d in ("BraTS", "ACDC", "COVID", "OASIS")
                if d in folder)


def make_corpus(dataset: str, root: str) -> str:
    """The seeded corpus of ``dataset`` under ``root`` (the 20 OASIS
    phantoms, or 8 of the others), made with the JAX package's
    generator; returns its folder."""
    from rdst_tpu.data import synthetic

    if dataset == "OASIS":
        data = os.path.join(root, "OASIS", "example20")
        synthetic.make_oasis_example(
            data, patient_ids=tuple(f"OAS1_{i:04d}_MR1"
                                    for i in range(1, 21)))
        return data
    maker, fmt = XDATA[dataset]
    data = os.path.join(root, dataset, "example8")
    getattr(synthetic, maker)(
        data, patient_ids=tuple(fmt.format(i) for i in range(1, 9)))
    return data


def score(name: str, data: str, out: str, dice: bool = False) -> dict:
    """One row through the JAX tester in this process (and with ``dice``
    its SR volumes through the JAX ``seg_eval``)."""
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
    out = {}
    if dice:
        from rdst_tpu.runners.seg_eval import seg_eval

        per_patient, _ = seg_eval(p, os.path.join(REPO, UNET), verbose=False)
        out["dice"] = [float(d) for d in np.mean(per_patient, axis=0)]
    if len(tester.sr_scales) > 1:  # 'psnr_1.5', ...: a score a scale
        return {**out, **{m: float(np.mean(v)) for m, v in stacked.items()}}
    if all(isinstance(v, dict) for v in stacked.values()):  # per modality
        return {**out, **{mod: {m.rsplit("_", 1)[0]: float(np.mean(v))
                                for m, v in rep.items()}
                          for mod, rep in stacked.items()}}
    return {**out, **{m.rsplit("_", 1)[0]: float(np.mean(v))
                      for m, v in stacked.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help=f"rows (default all): {list(ROWS)}")
    ap.add_argument("--data", default=None, help="an OASIS example20 corpus")
    ap.add_argument("--dice", action="store_true",
                    help="also score each row's SR volumes with seg_eval "
                    f"and {UNET} (default rows: {list(DICE_ROWS)})")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps({"row": args.one,
                          **score(args.one, args.data, args.out,
                                  args.dice)}),
              flush=True)
        return 0
    rows = args.rows or (DICE_ROWS if args.dice else list(ROWS))
    with tempfile.TemporaryDirectory() as tmp:
        corpora = {} if args.data is None else {"OASIS": args.data}
        for name in rows:
            dataset = dataset_of(ROWS[name][0])
            if dataset not in corpora:
                corpora[dataset] = make_corpus(dataset, tmp)
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       RDST_TPU_PALLAS_INTERPRET="1" if ROWS[name][3]
                       else "0")
            out = os.path.join(tmp, "out", name.replace(" ", "_"))
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", name,
                 "--data", corpora[dataset], "--out", out]
                + (["--dice"] if args.dice else []),
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
