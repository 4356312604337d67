"""Segmentation-UNet trainer (counterpart of
``rdst_tpu/runners/train_seg_unet.py``): the UNet that the ``UNet-F``
perceptual loss and ``runners.seg_eval`` read, trained on a dataset's HR
patches and labels with cross-entropy + Dice:

    python -m rdst_tpu_torch.runners.train_seg_unet \
        --config-file config_files/rdst_e1_oasis_x4.ini \
        --steps 2000 --out weights/unet_oasis_native.pkl [--gpu-id N]

* ``models.seg_unet.SegUNet`` with its BatchNorms in train mode (flax's
  batch statistics and running-average update, ``nn.layers.BatchNorm``);
* the loss: ``F.cross_entropy`` (mean over pixels, integer labels) +
  ``losses.seg_unet.dice_loss`` over every class;
* Adam with optax's defaults (``utils.optim.adam``);
* batches from ``OASISSegSRTrain.sample`` on
  ``np.random.default_rng(seed)``, as the JAX trainer draws them.

The saved pickle is the JAX trainer's: ``{'params', 'batch_stats'}`` as
numpy in flax names, which ``unet_native_ckpt`` and ``seg_eval`` of
either package read. Runs on ``cuda`` unless ``--gpu-id -1`` asks for the
CPU.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F


class SegUNetTrainer:
    """One ``SegUNet`` with its optimizer on ``device``; :meth:`step` is
    one update on a batch of ``OASISSegSRTrain.sample``."""

    def __init__(self, paras, lr: float = 1e-3, batch_size: int = 8,
                 patch: int = 96, seed: int = 0, device="cuda",
                 init_variables=None):
        from rdst_tpu_torch.data.readers import OASISSegSRTrain
        from rdst_tpu_torch.device import resolve_device
        from rdst_tpu_torch.models.seg_unet import SegUNet, init_seg_unet
        from rdst_tpu_torch.utils.optim import adam

        self.device = resolve_device(device)
        paras.set("batch_size", batch_size)
        paras.set("patch_size", patch // int(paras.sr_scale))
        self.ds = OASISSegSRTrain(paras)
        self.n_classes = int(max(np.max(lab) for lab in
                                 self.ds.segmentation_labels)) + 1
        channels = self.ds.hr_images[0].shape[-1]
        self.model = SegUNet(in_channels=channels, classes=self.n_classes)
        if init_variables is None:
            init_seg_unet(self.model, torch.Generator().manual_seed(seed))
        else:
            self.load_variables(init_variables)
        self.model.to(self.device).train()
        self.params = list(self.model.parameters())
        self.opt = adam(self.params, lr)

    def load_variables(self, variables) -> None:
        """Take flax-named ``{'params', 'batch_stats'}`` (numpy)."""
        from rdst_tpu_torch.checkpoint.convert import export_flax_tree

        self.model.load_state_dict({
            k: torch.as_tensor(np.array(v, np.float32))
            for k, v in export_flax_tree(variables).items()})

    def variables(self) -> dict:
        """``{'params', 'batch_stats'}`` as numpy in flax names."""
        from rdst_tpu_torch.checkpoint.convert import import_flax_tree

        return import_flax_tree(self.model.state_dict())

    def loss(self, x: torch.Tensor, labels: torch.Tensor):
        """(loss, pixel accuracy) of NHWC ``x`` against (N, H, W) labels,
        the running statistics moving as in a training forward."""
        from rdst_tpu_torch.losses.seg_unet import dice_loss

        _, _, logits = self.model(x, train=True)
        ce = F.cross_entropy(logits, labels)
        d = dice_loss(logits, labels, list(range(self.n_classes)))
        acc = (logits.detach().argmax(dim=1) == labels).float().mean()
        return ce + d, acc

    def step(self, batch):
        """One update; returns (loss, accuracy) as device tensors."""
        x = torch.from_numpy(np.ascontiguousarray(batch["out"], np.float32))
        labels = torch.from_numpy(np.asarray(batch["seg_gt"][..., 0]))
        loss, acc = self.loss(x.to(self.device, self.params[0].dtype),
                              labels.to(self.device).long())
        grads = torch.autograd.grad(loss, self.params)
        self.opt.step(list(grads))
        return loss.detach(), acc


def train_seg_unet(paras, steps: int = 1000, lr: float = 1e-3,
                   batch_size: int = 8, patch: int = 96, seed: int = 0,
                   log_every: int = 100, verbose: bool = True, device="cuda",
                   init_variables=None):
    """Train ``steps`` updates; returns (variables, the losses at every
    ``log_every`` steps)."""
    from rdst_tpu_torch.parallel.mesh import refuse_mesh

    refuse_mesh(paras, "train_seg_unet")
    trainer = SegUNetTrainer(paras, lr, batch_size, patch, seed, device,
                             init_variables)
    np_rng = np.random.default_rng(seed)
    losses = []
    for step in range(steps):
        loss, acc = trainer.step(trainer.ds.sample(np_rng))
        if (step + 1) % log_every == 0:
            l, a = float(loss), float(acc)
            losses.append(l)
            if verbose:
                print(f"[seg-unet] step {step + 1}/{steps} loss={l:.4f} "
                      f"acc={a:.4f}", flush=True)
    return trainer.variables(), losses


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the seg-loss UNet")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--out", default="weights/unet_oasis_native.pkl")
    ap.add_argument("--gpu-id", type=int, metavar="GPU",
                    help="CUDA device id; -1 runs on the CPU.")
    args = ap.parse_args(argv)

    from rdst_tpu_torch.cli import _device_of
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.device import resolve_device

    device = _device_of(args.gpu_id)
    resolve_device(device)  # no card and no --gpu-id -1: raise now
    paras = ParametersLoader(args.config_file)
    variables, _ = train_seg_unet(paras, args.steps, args.lr,
                                  args.batch_size, device=device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(variables, f)
    print(f"saved seg-UNet to {args.out} "
          f"(set unet_native_ckpt = '{args.out}' in the config)")
    return variables


if __name__ == "__main__":
    main()
