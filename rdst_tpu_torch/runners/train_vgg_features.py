"""VGG-feature substitute trainer (counterpart of
``rdst_tpu/runners/train_vgg_features.py``): the width-scaled VGG19
feature stack that the ``VGG22`` / ``VGG54`` / ``Minc_VGG*`` terms,
``lpips`` and FID's substitute read, trained as the encoder of a
denoising autoencoder on a dataset's HR slices:

    python -m rdst_tpu_torch.runners.train_vgg_features \
        --config-file config_files/rdst_e1_oasis_x4.ini \
        --steps 2000 --width 0.25 --out weights/vgg19_features_native.pkl \
        [--gpu-id N]

* the encoder: ``losses.vgg.VGG19Features`` at tap ``54`` and ``width``;
* the decoder (discarded): four stages of nearest x2, a 3x3 conv and a
  ReLU, then a 3x3 conv back to the input's channels;
* the loss: MSE of the reconstruction against the clean patch; Adam with
  optax's defaults (``utils.optim.adam``);
* the batches: :meth:`VGGFeatureTrainer.sample_batch`, the JAX trainer's
  sampler line for line, so one numpy generator draws the same crops and
  noise in both packages.

The saved pickle is the JAX trainer's, ``{'width', 'params' (the
encoder's, flax names: ``conv_i`` with HWIO ``kernel`` and ``bias``),
'losses'}``, which ``VGGLoss`` and FID of either package read. Runs on
``cuda`` unless ``--gpu-id -1`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class DenoisingAutoencoder(nn.Module):
    """The VGG19 feature stack (the deliverable) and a light conv decoder,
    on NCHW tensors; modules named as the JAX trainer's flax modules
    (``encoder``, ``dec_0`` ... ``dec_3``, ``dec_out``)."""

    def __init__(self, width: float, channels: int = 3):
        super().__init__()
        from rdst_tpu_torch.losses.vgg import _TAPS, VGG19Features

        self.encoder = VGG19Features(_TAPS["54"], width)
        cin = self.encoder.convs[-1].out_channels
        self.n_dec = 4
        for i, ch in enumerate((128, 64, 32, 16)):
            cout = max(8, int(ch * width * 4))
            setattr(self, f"dec_{i}", nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.dec_out = nn.Conv2d(cin, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.encoder(x)
        for i in range(self.n_dec):
            y = F.interpolate(y, scale_factor=2, mode="nearest")
            y = F.relu(getattr(self, f"dec_{i}")(y))
        return self.dec_out(y)

    def _convs(self):
        """(flax path, conv) of every conv."""
        for i, conv in enumerate(self.encoder.convs):
            yield ("encoder", f"conv_{i}"), conv
        for i in range(self.n_dec):
            yield (f"dec_{i}",), getattr(self, f"dec_{i}")
        yield ("dec_out",), self.dec_out

    def load_variables(self, variables: dict) -> None:
        """Take the JAX model's ``{'params': ...}`` (numpy)."""
        with torch.no_grad():
            for path, conv in self._convs():
                p = variables["params"]
                for k in path:
                    p = p[k]
                conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(
                    np.array(p["bias"], np.float32)))

    def variables(self) -> dict:
        """``{'params': ...}`` as numpy in flax names."""
        params: dict = {}
        for path, conv in self._convs():
            tree = params
            for k in path[:-1]:
                tree = tree.setdefault(k, {})
            tree[path[-1]] = {
                "kernel": np.ascontiguousarray(
                    conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)),
                "bias": conv.bias.detach().cpu().numpy().copy()}
        return {"params": params}


def init_autoencoder(model: DenoisingAutoencoder,
                     generator: torch.Generator) -> DenoisingAutoencoder:
    """Seeded initialization: conv kernels uniform within sqrt(1 / fan_in)
    (the JAX package's ``torch_conv_init``), biases 0 (flax's default)."""
    with torch.no_grad():
        for _, conv in model._convs():
            bound = conv.weight[0].numel() ** -0.5
            conv.weight.copy_((2 * torch.rand(conv.weight.shape,
                                              generator=generator) - 1)
                              * bound)
            conv.bias.zero_()
    return model


class VGGFeatureTrainer:
    """The autoencoder with its optimizer on ``device``; :meth:`step` is
    one update on a batch of :meth:`sample_batch`."""

    def __init__(self, paras, width: float = 0.25, lr: float = 2e-4,
                 batch_size: int = 16, patch: int = 64, noise: float = 0.1,
                 seed: int = 0, device="cuda", init_variables=None):
        from rdst_tpu_torch.data.readers import make_train_valid_datasets
        from rdst_tpu_torch.device import resolve_device
        from rdst_tpu_torch.utils.optim import adam

        self.device = resolve_device(device)
        self.width, self.batch_size = width, batch_size
        self.patch, self.noise = patch, noise
        ds_train, _ = make_train_valid_datasets(paras)
        self.slices = [np.asarray(s, np.float32) for s in ds_train.hr_images]
        self.rng = np.random.default_rng(seed)
        self.model = DenoisingAutoencoder(width)
        if init_variables is None:
            init_autoencoder(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_variables(init_variables)
        self.model.to(self.device)
        self.params = list(self.model.parameters())
        self.opt = adam(self.params, lr)

    def sample_batch(self):
        """(noisy, clean) NHWC float32 numpy: 3-channel crops of random
        slices, zero-padded where a slice is smaller than the patch."""
        rng, patch = self.rng, self.patch
        xs = []
        for _ in range(self.batch_size):
            s = self.slices[rng.integers(len(self.slices))]
            h, w = s.shape[:2]
            i = rng.integers(max(h - patch, 0) + 1)
            j = rng.integers(max(w - patch, 0) + 1)
            crop = s[i:i + patch, j:j + patch]
            if crop.shape[:2] != (patch, patch):
                crop = np.pad(crop, ((0, patch - crop.shape[0]),
                                     (0, patch - crop.shape[1]), (0, 0)))
            xs.append(np.repeat(crop[..., :1], 3, axis=-1))
        clean = np.stack(xs)
        noisy = clean + self.noise * rng.standard_normal(clean.shape,
                                                         dtype=np.float32)
        return noisy, clean

    def loss(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        rec = self.model(noisy.permute(0, 3, 1, 2))
        return torch.mean((rec - clean.permute(0, 3, 1, 2)) ** 2)

    def step(self, noisy: np.ndarray, clean: np.ndarray) -> torch.Tensor:
        """One update; returns the loss as a device tensor."""
        dtype = self.params[0].dtype
        loss = self.loss(torch.from_numpy(noisy).to(self.device, dtype),
                         torch.from_numpy(clean).to(self.device, dtype))
        self.opt.step(list(torch.autograd.grad(loss, self.params)))
        return loss.detach()


def train_vgg_features(paras, steps: int = 2000, width: float = 0.25,
                       lr: float = 2e-4, batch_size: int = 16,
                       patch: int = 64, noise: float = 0.1, seed: int = 0,
                       log_every: int = 200, verbose: bool = True,
                       device="cuda", init_variables=None):
    """Train ``steps`` updates; returns ``{'width', 'params' (the
    encoder's), 'losses'}`` (the loss at every ``log_every`` steps and
    at the last)."""
    from rdst_tpu_torch.parallel.mesh import refuse_mesh

    refuse_mesh(paras, "train_vgg_features")
    trainer = VGGFeatureTrainer(paras, width, lr, batch_size, patch, noise,
                                seed, device, init_variables)
    losses = []
    for step in range(1, steps + 1):
        loss = trainer.step(*trainer.sample_batch())
        if step % log_every == 0 or step == steps:
            losses.append(float(loss))
            if verbose:
                print(f"[vgg-dae] step {step}/{steps} mse={losses[-1]:.5f}")
    return {"width": width,
            "params": trainer.model.variables()["params"]["encoder"],
            "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the VGG feature stack")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--out", default="weights/vgg19_features_native.pkl")
    ap.add_argument("--gpu-id", type=int, metavar="GPU",
                    help="CUDA device id; -1 runs on the CPU.")
    args = ap.parse_args(argv)

    from rdst_tpu_torch.cli import _device_of
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.device import resolve_device

    device = _device_of(args.gpu_id)
    resolve_device(device)  # no card and no --gpu-id -1: raise now
    paras = ParametersLoader(args.config_file)
    blob = train_vgg_features(paras, steps=args.steps, width=args.width,
                              batch_size=args.batch_size, patch=args.patch,
                              device=device)
    with open(args.out, "wb") as f:
        pickle.dump(blob, f)
    print(f"saved {args.out} (width={blob['width']}, "
          f"final mse={blob['losses'][-1]:.5f})")
    return blob


if __name__ == "__main__":
    main()
