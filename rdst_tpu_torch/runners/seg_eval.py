"""Offline segmentation quality of SR volumes (counterpart of
``rdst_tpu/runners/seg_eval.py``):

    python -m rdst_tpu_torch.runners.seg_eval --config-file cfg.ini \
        --unet weights/unet_tiny.pkl [--scale 4] [--gpu-id N]

For every testing patient: the tester's saved SR volume
(``inference_results/{pid}_inference_results.npz``, written by either
package) and the patient's GT slices go through the frozen segmentation
UNet (``models.seg_unet.SegUNet``, eval mode: the BatchNorms on their
running statistics), the labels are the argmax of its logits, and the
per-class Dice of the SR labels against the GT labels is tabulated per
patient with a MEAN row. Runs on ``cuda`` unless ``--gpu-id -1`` asks for
the CPU. The UNet is the pickle the JAX package's trainer writes (flax
names, HWIO kernels, numpy), as ``runners.train_seg_unet`` writes it too.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

# slices a UNet forward; any batch gives the same labels
SEGMENT_BATCH = 16


def load_unet(path_or_variables, in_channels: int, device="cpu"):
    """The frozen ``SegUNet`` of a UNet pickle (or its loaded variables)
    on ``device``, in eval mode; its class count from the head's bias."""
    from rdst_tpu_torch.checkpoint.convert import export_flax_tree
    from rdst_tpu_torch.models.seg_unet import SegUNet

    variables = path_or_variables
    if isinstance(variables, str):
        with open(variables, "rb") as f:
            variables = pickle.load(f)
    n_classes = int(np.shape(
        variables["params"]["segmentation_head"]["bias"])[-1])
    unet = SegUNet(in_channels=in_channels, classes=n_classes)
    unet.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                          for k, v in export_flax_tree(variables).items()})
    return unet.requires_grad_(False).eval().to(device)


def unet_logits(unet, vol: np.ndarray) -> torch.Tensor:
    """NCHW logits of an NHWC volume, on the UNet's device."""
    dev = next(unet.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(vol, np.float32))
    with torch.inference_mode():
        return torch.cat([unet(x[i:i + SEGMENT_BATCH].to(dev))[2]
                          for i in range(0, x.shape[0], SEGMENT_BATCH)])


def segment(unet, vol: np.ndarray) -> np.ndarray:
    """Per-pixel labels (N, H, W) of an NHWC volume."""
    return unet_logits(unet, vol).argmax(dim=1).cpu().numpy()


def seg_eval(paras, unet_ckpt: str, scale: float = None,
             verbose: bool = True, device="cuda"):
    """Per-patient, per-class Dice of the SR volumes' segmentation against
    the GT's; returns ``(dice (patients, classes), table)``."""
    from rdst_tpu_torch.data.readers import (make_test_dataset,
                                             testing_patient_ids)
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.metrics.evaluation import tabulate
    from rdst_tpu_torch.metrics.image_metrics import dice_coefficient
    from rdst_tpu_torch.parallel.mesh import refuse_mesh
    from rdst_tpu_torch.utils.figures import _load_sr_volume

    refuse_mesh(paras, "seg_eval")
    device = resolve_device(device)
    scale = scale or max(paras.test_sr_scales)
    unet = None
    rows, all_dice = [], []
    for pid in testing_patient_ids(paras):
        ds = make_test_dataset(paras, [pid])
        if unet is None:
            unet = load_unet(unet_ckpt, ds.input_channels, device)
        sr_vol = _load_sr_volume(paras, pid, scale)
        gts = np.stack([ds.get_test_pair(i)[scale]["gt"]
                        for i in range(ds.test_len())])
        dice = dice_coefficient(segment(unet, gts), segment(unet, sr_vol),
                                unet.segmentation_head.out_channels)
        all_dice.append(dice)
        rows.append([pid] + [f"{d:.4f}" for d in dice])

    headers = ["patient"] + [f"class{c}" for c in range(len(all_dice[0]))]
    rows.append(["MEAN"] + [f"{d:.4f}" for d in np.mean(all_dice, axis=0)])
    table = tabulate(rows, headers=headers)
    if verbose:
        print(table)
    return np.asarray(all_dice), table


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dice evaluation of SR volumes")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--unet", required=True)
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--gpu-id", type=int, metavar="GPU",
                    help="CUDA device id; -1 runs on the CPU.")
    args = ap.parse_args(argv)

    from rdst_tpu_torch.cli import _device_of
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.device import resolve_device

    device = _device_of(args.gpu_id)
    resolve_device(device)  # no card and no --gpu-id -1: raise now
    paras = ParametersLoader(args.config_file)
    return seg_eval(paras, args.unet, args.scale, device=device)


if __name__ == "__main__":
    main()
