"""Segmentation-UNet perceptual loss, the ``'UNet-F'`` term (counterpart
of ``rdst_tpu/losses/seg_unet.py``).

A frozen UNet (``models.seg_unet``, eval mode) scores the prediction in
the mode named by the single key of ``unet_loss_layers``:

* ``encoder-*``: the selected encoder stages of prediction and target;
* ``decoder-*``: the decoder outputs;
* ``label-hr``: Dice of the prediction's logits against the argmax of
  the target's;
* ``label-gt``: Dice against the dataset's labels (``batch['seg_gt']``).

Parity quirks of the reference, kept: ``L1`` in the mode means MSE and
``L2`` means MAE, and the encoder loss divides by ``len(loss_layers)``
inside its loop. No gradient reaches the UNet's weights; it flows through
the UNet to the prediction.

Weights: the pickle ``unet_native_ckpt`` names (the JAX package's
variables as numpy), else a seeded random UNet with a warning. The JAX
package draws that random UNet from ``jax.random.PRNGKey(0)``, which the
port cannot draw: its own comes from ``torch.Generator().manual_seed(0)``
(a difference by design; name a checkpoint to score with one UNet in
both packages).
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.seg_unet import SegUNet, init_seg_unet

_MODE_CONFIG = {
    "OASIS": dict(in_channels=1, classes=4),
    "BraTS": dict(in_channels=4, classes=4),
    "ACDC": dict(in_channels=1, classes=4),
    "COVID": dict(in_channels=1, classes=4),
}


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              classes: Sequence[int]) -> torch.Tensor:
    """Multiclass Dice loss (smp's DiceLoss): softmax probabilities of
    NCHW ``logits``, per-class dice over batch and space against the
    one-hot of ``labels`` (N, H, W), mean over ``classes``."""
    probs = torch.softmax(logits, dim=1)
    onehot = F.one_hot(labels.long(), logits.shape[1]).permute(0, 3, 1, 2)
    onehot = onehot.to(probs.dtype)
    inter = (probs * onehot).sum(dim=(0, 2, 3))
    card = (probs + onehot).sum(dim=(0, 2, 3))
    dice = (2.0 * inter + 1e-7) / (card + 1e-7)
    return 1.0 - dice[list(classes)].mean()


class SegUNetLoss(nn.Module):
    """Callable ``term(pred, target, batch)`` on NHWC tensors."""

    def __init__(self, paras, variables=None):
        super().__init__()
        mode = paras.unet_loss_mode
        base = next((k for k in _MODE_CONFIG if k in mode), "OASIS")
        cfg = _MODE_CONFIG[base]
        self.dice_classes = ([1, 2, 3] if ("tumor_only" in mode
                                           or "lesion_only" in mode)
                             else [0, 1, 2, 3])
        loss_layers = paras.unet_loss_layers
        self.loss_mode = list(loss_layers.keys())[-1]
        self.loss_layers = list(loss_layers[self.loss_mode])
        self.model = SegUNet(**cfg)
        if variables is None:
            variables = self._load(paras)
        if variables is None:
            init_seg_unet(self.model, torch.Generator().manual_seed(0))
        else:
            from rdst_tpu_torch.checkpoint.convert import export_flax_tree

            self.model.load_state_dict({
                k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in export_flax_tree(variables).items()})
        self.model.requires_grad_(False).eval()
        if "L1" in self.loss_mode:  # the reference's swap, kept
            self.feat_loss = lambda a, b: torch.mean((a - b) ** 2)
        else:
            self.feat_loss = lambda a, b: torch.mean(torch.abs(a - b))

    @staticmethod
    def _load(paras):
        native = paras.get("unet_native_ckpt")
        if native and os.path.exists(native):
            with open(native, "rb") as f:
                return pickle.load(f)
        path = paras.get("unet_pt_path") or os.environ.get("RDST_TPU_UNET_PT")
        if path and os.path.exists(path):
            warnings.warn(
                f"SegUNetLoss: unet_pt_path={path!r} is set, but importing "
                "torch smp-UNet checkpoints is not supported; point "
                "unet_native_ckpt at a native UNet pickle.")
        warnings.warn(
            "SegUNetLoss: no pre-trained UNet weights found; using a frozen "
            "random-initialized UNet (structured perceptual prior).")
        return None

    def forward(self, pred, target, batch=None) -> torch.Tensor:
        unet = self.model
        if "encoder" in self.loss_mode:
            sr_feats = unet(pred)[0]
            with torch.no_grad():
                hr_feats = unet(target)[0]
            loss = pred.new_zeros((), dtype=torch.float32)
            for layer in self.loss_layers:
                loss = loss + self.feat_loss(sr_feats[layer], hr_feats[layer])
                loss = loss / len(self.loss_layers)  # inside the loop: parity
            return loss
        if "decoder" in self.loss_mode:
            sr_dec = unet(pred)[1]
            with torch.no_grad():
                hr_dec = unet(target)[1]
            return self.feat_loss(sr_dec, hr_dec)
        if self.loss_mode == "label-hr":
            sr_logits = unet(pred)[2]
            with torch.no_grad():
                hr_label = unet(target)[2].argmax(dim=1)
            return dice_loss(sr_logits, hr_label, self.dice_classes)
        if self.loss_mode == "label-gt":
            if batch is None or "seg_gt" not in batch:
                raise ValueError("label-gt needs seg_gt in the batch")
            gt = batch["seg_gt"]
            if gt.dim() == 4:
                gt = gt[..., 0]
            return dice_loss(unet(pred)[2], gt, self.dice_classes)
        raise ValueError(f"Invalid UNet Seg Loss Mode: {self.loss_mode}")
