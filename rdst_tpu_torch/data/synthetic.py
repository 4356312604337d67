"""Synthetic medical-volume fixtures.

The port's own copy of ``rdst_tpu/data/synthetic.py`` (numpy and the standard
library only), kept so that the port imports nothing of ``rdst_tpu``.

The reference ships example OASIS data whose ``.img`` payloads are
stripped from the mirror (upstream .MISSING_LARGE_BLOBS), so this
module generates structurally-equivalent phantoms in the same on-disk
layout. Phantoms are concentric "tissue" ellipsoids (CSF / gray / white)
with smooth random texture — enough structure for SR training/eval and
for the segmentation-loss path (labels included).

Layouts produced (matching what the reference datasets glob):
* OASIS:   {root}/{pid}/PROCESSED/MPRAGE/T88_111/{pid}_masked_gfc.img(.hdr)
           {root}/{pid}/FSL_SEG/{pid}_masked_gfc_fseg.img(.hdr)
* BraTS:   {root}/{pid}/{pid}_{modality}.nii.gz + {pid}_seg.nii.gz
* ACDC:    {root}/{pid}/{pid}_frame{XX}.nii.gz + _frame{XX}_gt.nii.gz
* COVID:   {root}/{pid}.nii.gz + {root}/mask/{pid}_mask.nii.gz

The BraTS, ACDC and COVID makers take ``only``: write just those of
``patient_ids``, each with the volumes its place in ``patient_ids``
seeds (a tester reads only its testing patients).

Run as a script to create the OASIS example tree:
    python -m rdst_tpu_torch.data.synthetic [--root data/OASIS/example]
"""

from __future__ import annotations

import os
from os.path import join
from typing import Tuple

import numpy as np
from rdst_tpu_torch.utils.ndfilters import gaussian_filter

from rdst_tpu_torch.data import io


def _smooth_noise(rng: np.random.Generator, shape, sigma: float = 6.0) -> np.ndarray:
    x = gaussian_filter(rng.normal(0, 1, shape), sigma)
    x = (x - x.min()) / (x.max() - x.min() + 1e-12)
    return x


def brain_phantom(
    rng: np.random.Generator,
    shape: Tuple[int, int, int] = (96, 112, 96),
    n_classes: int = 4,
    bg_noise: float = 0.0,
):
    """Returns (volume float32 in [0, max], labels uint8 in [0, n_classes-1]).

    Class 0 = background, then CSF / gray / white as nested ellipsoids.
    """
    zz, yy, xx = np.meshgrid(
        *[np.linspace(-1, 1, s) for s in shape], indexing="ij"
    )
    # mildly random ellipsoid axes per subject
    ax = 0.75 + 0.1 * rng.random(3)
    r = np.sqrt((zz / ax[0]) ** 2 + (yy / ax[1]) ** 2 + (xx / ax[2]) ** 2)
    # wobble the boundary so labels aren't analytic spheres
    r = r + 0.12 * (_smooth_noise(rng, shape, 8.0) - 0.5)

    labels = np.zeros(shape, dtype=np.uint8)
    radii = np.linspace(1.0, 0.35, n_classes)  # class 1 outermost ... inner
    for cls, rad in enumerate(radii, start=0):
        if cls == 0:
            continue
        labels[r < rad] = cls

    intensities = np.linspace(0.25, 0.9, n_classes)  # per-class base signal
    vol = np.zeros(shape, dtype=np.float64)
    for cls in range(1, n_classes):
        vol[labels == cls] = intensities[cls - 1]
    vol += 0.25 * _smooth_noise(rng, shape, 2.5) * (labels > 0)
    vol += 0.01 * rng.normal(0, 1, shape) * (labels > 0)
    if bg_noise:
        # unmasked scanner-noise floor: real acquisitions are never
        # exactly constant anywhere, and exactly-constant patches give
        # LayerNorm zero variance — its backward then amplifies by
        # 1/sqrt(eps) per block and the gradients overflow (observed on
        # the noise-free COVID corpus; guarded in the trainer, but the
        # data should be realistic too)
        vol += bg_noise * np.abs(rng.normal(0, 1, shape))
    vol = np.clip(vol, 0, None)
    # scanner-like arbitrary intensity scale (reference normalizes per-patient)
    vol *= float(rng.uniform(800, 3000))
    return vol.astype(np.float32), labels


def make_oasis_example(
    root: str,
    patient_ids=("OAS1_0001_MR1", "OAS1_0002_MR1", "OAS1_0003_MR1", "OAS1_0004_MR1"),
    shape: Tuple[int, int, int] = (96, 112, 96),
    seed: int = 0,
) -> None:
    """Create an OASIS-layout example tree of Analyze .img/.hdr phantoms."""
    for i, pid in enumerate(patient_ids):
        rng = np.random.default_rng(seed + i)
        vol, labels = brain_phantom(rng, shape)
        img_dir = join(root, pid, "PROCESSED", "MPRAGE", "T88_111")
        seg_dir = join(root, pid, "FSL_SEG")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)
        # 4D (H, W, D, 1) like real OASIS Analyze volumes
        io.save(join(img_dir, f"{pid}_masked_gfc.img"), vol[..., None])
        io.save(join(seg_dir, f"{pid}_masked_gfc_fseg.img"), labels[..., None].astype(np.uint8))


def make_brats_example(
    root: str,
    patient_ids=("HGG_Brats17_SYN_001_1", "HGG_Brats17_SYN_002_1"),
    modalities=("t1ce", "t1", "t2", "flair"),
    shape: Tuple[int, int, int] = (80, 96, 64),
    seed: int = 0,
    only=None,
) -> None:
    for i, pid in enumerate(patient_ids):
        if only is not None and pid not in only:
            continue
        rng = np.random.default_rng(seed + 100 + i)
        # reference path layout: {root}/{group}/{name}/ for pid "{group}_{name}"
        group = pid.split("_")[0]
        name = pid[len(group) + 1 :]
        pdir = join(root, group, name)
        os.makedirs(pdir, exist_ok=True)
        _, labels = brain_phantom(rng, shape, n_classes=4)
        # BraTS label convention uses {0,1,2,4}; reference remaps 4->3
        lab = labels.astype(np.uint8).copy()
        lab[lab == 3] = 4
        io.save(join(pdir, f"{name}_seg.nii.gz"), lab)
        for j, m in enumerate(modalities):
            vol, _ = brain_phantom(np.random.default_rng(seed + 100 + i * 10 + j), shape)
            io.save(join(pdir, f"{name}_{m}.nii.gz"), vol)


def make_acdc_example(
    root: str,
    patient_ids=("patient001", "patient002"),
    shape: Tuple[int, int, int] = (160, 160, 10),
    seed: int = 0,
    only=None,
) -> None:
    for i, pid in enumerate(patient_ids):
        if only is not None and pid not in only:
            continue
        pdir = join(root, pid)
        os.makedirs(pdir, exist_ok=True)
        for frame in (1, 12):
            rng = np.random.default_rng(seed + 200 + i * 10 + frame)
            vol, labels = brain_phantom(rng, shape, n_classes=4)
            io.save(join(pdir, f"{pid}_frame{frame:02d}.nii.gz"), vol)
            io.save(join(pdir, f"{pid}_frame{frame:02d}_gt.nii.gz"), labels.astype(np.uint8))


def make_covid_example(
    root: str,
    patient_ids=("volume-covid19-A-0001", "volume-covid19-A-0002"),
    shape: Tuple[int, int, int] = (630, 630, 20),
    seed: int = 0,
    only=None,
) -> None:
    os.makedirs(join(root, "mask"), exist_ok=True)
    for i, pid in enumerate(patient_ids):
        if only is not None and pid not in only:
            continue
        rng = np.random.default_rng(seed + 300 + i)
        # CT-like noise floor OUTSIDE the anatomy too: the 512 centre
        # crop keeps large air regions, and exactly-constant patches
        # blow up LayerNorm backward (see brain_phantom.bg_noise)
        vol, labels = brain_phantom(rng, shape, n_classes=3, bg_noise=0.005)
        io.save(join(root, f"{pid}.nii.gz"), vol)
        # reference globs mask/{pid}.nii.gz (CovidCT_dataset.py:65)
        io.save(join(root, "mask", f"{pid}.nii.gz"), (labels > 1).astype(np.uint8))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Generate synthetic example volumes")
    ap.add_argument("--root", default="data/OASIS/example")
    ap.add_argument("--dataset", default="oasis", choices=["oasis", "brats", "acdc", "covid"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    metavar=("H", "W", "Z"),
                    help="Override the volume shape (smaller = faster "
                         "smoke runs; each dataset has its own default).")
    ap.add_argument("--n-patients", type=int, default=None,
                    help="Override the number of phantoms; ids follow each "
                         "dataset's reference naming (oasis OAS1_{n:04d}_MR1, "
                         "brats HGG_Brats17_SYN_{n:03d}_1, acdc patient{n:03d}, "
                         "covid volume-covid19-A-{n:04d}).")
    args = ap.parse_args()
    maker = {
        "oasis": make_oasis_example,
        "brats": make_brats_example,
        "acdc": make_acdc_example,
        "covid": make_covid_example,
    }[args.dataset]
    id_format = {
        "oasis": "OAS1_{:04d}_MR1",
        "brats": "HGG_Brats17_SYN_{:03d}_1",
        "acdc": "patient{:03d}",
        "covid": "volume-covid19-A-{:04d}",
    }[args.dataset]
    kwargs = {}
    if args.n_patients is not None:
        kwargs["patient_ids"] = tuple(
            id_format.format(i) for i in range(1, args.n_patients + 1))
    if args.shape is not None:
        kwargs["shape"] = tuple(args.shape)
    maker(args.root, seed=args.seed, **kwargs)
    print(f"wrote synthetic {args.dataset} example data to {args.root}")
