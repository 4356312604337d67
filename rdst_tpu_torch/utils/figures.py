"""Qualitative figures and training-record plots (counterpart of
``rdst_tpu/utils/figures.py``):

    python -m rdst_tpu_torch.utils.figures --config-file cfg.ini \
        --patient OAS1_0019_MR1 --slices 20 30 --zoom 40 40 32 32 \
        [--unet weights/unet_tiny.pkl] [--gpu-id N] --out figures/

The numbers behind each figure come from functions that need no
matplotlib: :func:`patient_figure_data` (per slice the LR, bicubic, SR
and GT images, bicubic and SR PSNR, and with a segmentation UNet the
per-class Dice of the SR's labels against the GT's) and
:func:`training_record_series` (the loss curves of a training output
directory). The two drawing functions, :func:`render_patient_figures` and
:func:`plot_training_records`, import matplotlib when called; where it is
not installed they raise its ``ImportError``.

SR volumes are the tester's ``{pid}_inference_results.npz`` (key
``x{scale}``), which both packages write.
"""

from __future__ import annotations

import argparse
import json
import os
from os.path import exists, join

import numpy as np


def _load_sr_volume(paras, pid: str, scale: float):
    gan_type = paras.get("gan_type", "None")
    root = join(paras.output_dir,
                f"{paras.model_name}_{gan_type}_Final_Predictions",
                "inference_results", f"{pid}_inference_results.npz")
    if not exists(root):
        raise FileNotFoundError(
            f"no saved inference results at {root} -- run the tester first")
    with np.load(root) as z:
        return z[f"x{scale}"]


def patient_figure_data(paras, pid: str, slice_ids, scale: float = None,
                        unet_ckpt: str = None, device="cuda") -> list:
    """Per slice of ``slice_ids``: ``{'slice', 'LR', 'Bicubic', 'SR',
    'GT', 'psnr': {'Bicubic', 'SR'}}`` and, when ``unet_ckpt`` exists,
    ``'dice'``: the per-class Dice of the UNet's SR labels against its GT
    labels (the figure's title shows the mean over classes 1 and up)."""
    from rdst_tpu_torch.data import ops
    from rdst_tpu_torch.data.readers import make_test_dataset
    from rdst_tpu_torch.metrics.image_metrics import dice_coefficient, psnr

    scale = scale or max(paras.test_sr_scales)
    ds = make_test_dataset(paras, [pid])
    sr_vol = _load_sr_volume(paras, pid, scale)
    unet = None
    if unet_ckpt and exists(unet_ckpt):
        from rdst_tpu_torch.device import resolve_device
        from rdst_tpu_torch.runners.seg_eval import load_unet, segment

        unet = load_unet(unet_ckpt, ds.input_channels,
                         resolve_device(device))
    out = []
    for i in slice_ids:
        pair = ds.get_test_pair(i)[scale]
        lr, gt, sr = pair["in"][0], pair["gt"], sr_vol[i]
        bic = ops.resize(lr, gt.shape[:2])
        row = {"slice": i, "LR": lr, "Bicubic": bic, "SR": sr, "GT": gt,
               "psnr": {"Bicubic": psnr(gt, bic), "SR": psnr(gt, sr)}}
        if unet is not None:
            labels = segment(unet, np.stack([sr, gt]))
            row["dice"] = dice_coefficient(labels[1], labels[0])
        out.append(row)
    return out


def render_patient_figures(paras, pid: str, slice_ids, scale: float = None,
                           zoom=None, unet_ckpt: str = None,
                           out_dir: str = "figures", device="cuda"):
    """One PNG a slice: LR / bicubic / SR / GT (and a zoomed row), the
    PSNRs and the SR's mean Dice in the titles; returns the paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scale = scale or max(paras.test_sr_scales)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for row in patient_figure_data(paras, pid, slice_ids, scale, unet_ckpt,
                                   device):
        names = ("LR", "Bicubic", "SR", "GT")
        rows = 2 if zoom else 1
        fig, axes = plt.subplots(rows, len(names),
                                 figsize=(3 * len(names), 3 * rows),
                                 squeeze=False)
        ref_h = row["GT"].shape[0]
        for j, name in enumerate(names):
            img = row[name]
            axes[0][j].imshow(np.clip(img[..., 0], 0, 1), cmap="gray")
            title = name
            if name in row["psnr"]:
                title += f" ({row['psnr'][name]:.2f} dB)"
            if name == "SR" and "dice" in row:
                title += f"\nDice {np.mean(row['dice'][1:]):.3f}"
            axes[0][j].set_title(title, fontsize=9)
            axes[0][j].axis("off")
            if zoom:
                y0, x0, hh, ww = zoom
                sy = img.shape[0] / ref_h
                yy, xx = int(y0 * sy), int(x0 * sy)
                zh, zw = max(int(hh * sy), 1), max(int(ww * sy), 1)
                axes[1][j].imshow(
                    np.clip(img[yy:yy + zh, xx:xx + zw, 0], 0, 1),
                    cmap="gray")
                axes[1][j].axis("off")
        path = join(out_dir, f"{pid}_slice{row['slice']}_x{scale}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)
        paths.append(path)
    return paths


def training_record_series(output_root: str) -> dict:
    """The curves of a training output directory: ``{'loss': {state:
    total loss a step}}`` from ``final_results/training_records.npy``
    and ``{'components': {state: {term: values}}}`` from the checkpoint's
    ``host_state.json`` (the per-term records; for a GAN state the
    discriminator's real and fake terms apart)."""
    series = {"loss": {}, "components": {}}
    rec_path = join(output_root, "final_results", "training_records.npy")
    if exists(rec_path):
        records = np.load(rec_path, allow_pickle=True).item()
        series["loss"] = {ts: np.asarray(v, np.float64) for ts, v in
                          records.get("training_loss_records", {}).items()}
    host_path = join(output_root, "checkpoint", "host_state.json")
    if exists(host_path):
        with open(host_path) as f:
            comp = json.load(f).get("loss_records", {})
        comp = comp.get("records", comp)  # SRLoss.state_dict's wrapper
        series["components"] = {
            ts: {name: np.asarray(v, np.float64)
                 for name, v in sorted(by_name.items())}
            for ts, by_name in comp.items()
            if isinstance(by_name, dict) and by_name}
    return series


def plot_training_records(output_root: str, out_dir: str = None):
    """Loss and per-term curves of a training output directory as PNGs
    under ``out_dir`` (default ``{output_root}/plots``); returns the
    paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = out_dir or join(output_root, "plots")
    os.makedirs(out_dir, exist_ok=True)
    series = training_record_series(output_root)
    written = []
    for ts, losses in series["loss"].items():
        plt.plot(losses)
        plt.xlabel("epoch")
        plt.ylabel("loss")
        plt.title(ts)
        plt.grid(True)
        p = join(out_dir, f"replot_{ts}_loss.png")
        plt.savefig(p)
        plt.close()
        written.append(p)
    for ts, by_name in series["components"].items():
        for name, vals in by_name.items():
            plt.plot(vals, label=name, lw=0.8)
        plt.xlabel("recorded step")
        plt.ylabel("loss component")
        plt.yscale("log")
        plt.title(f"{ts} components")
        plt.legend()
        plt.grid(True, which="both", alpha=0.3)
        p = join(out_dir, f"replot_{ts}_components.png")
        plt.savefig(p)
        plt.close()
        written.append(p)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description="Render qualitative SR figures")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--patient", required=True)
    ap.add_argument("--slices", type=int, nargs="+", default=[0])
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--zoom", type=int, nargs=4, default=None,
                    metavar=("Y", "X", "H", "W"))
    ap.add_argument("--unet", default=None)
    ap.add_argument("--out", default="figures")
    ap.add_argument("--gpu-id", type=int, metavar="GPU",
                    help="CUDA device id; -1 runs on the CPU.")
    args = ap.parse_args(argv)

    from rdst_tpu_torch.cli import _device_of
    from rdst_tpu_torch.config import ParametersLoader

    paras = ParametersLoader(args.config_file)
    paths = render_patient_figures(paras, args.patient, args.slices,
                                   args.scale, args.zoom, args.unet,
                                   args.out, _device_of(args.gpu_id))
    for p in paths:
        print(f"wrote {p}")


if __name__ == "__main__":
    main()
