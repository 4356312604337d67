"""The adversarial loss family (counterpart of
``rdst_tpu/losses/adversarial.py``): the discriminator, its optimizer and
the alternating update the trainer runs.

* :meth:`ScaleAdversarial.d_step`: ``gan_k`` discriminator updates on
  (detached fake, real), for GAN (BCE on logits), RaGAN (relativistic),
  WGAN (mean difference, then the parameters clipped to
  ``wgan_clip_value``), ``*GP*`` (gradient penalty at a random
  interpolation, coefficient 10) and ScaleGAN (L1 against 1 and 1 /
  scale). The discriminator runs in training mode, on the fake batch and
  then on the real one, so its BatchNorm statistics move twice an update.
  Each update is guarded on the device: a non-finite loss or gradient
  leaves the parameters, the optimizer state and the running statistics
  as they were, without the host reading anything.
* :meth:`ScaleAdversarial.g_loss` / :meth:`generator_loss`: the
  generator's objective against the (already updated) discriminator in
  eval mode.
* The optimizer: the config's (``utils.optim.Optimizer``, its count moving
  once a discriminator update), or Adam(1e-5, b1 0, b2 0.9) for ``*GP*``;
  with ``reduce`` (the trainer's, on a data axis) applied to its flat
  gradient.

The discriminator is float32 whatever the generator's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from rdst_tpu_torch.losses.discriminators import (CNNDiscriminator,
                                                  build_discriminator,
                                                  init_discriminator)
from rdst_tpu_torch.utils.optim import Optimizer, tree_finite

GP_ADAM = {"opt": "Adam", "learning_rate": 1e-5, "beta1": 0.0, "beta2": 0.9,
           "epsilon": 1e-8, "weight_decay": 0, "lr_decay_type": None}


def _bce_logits(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels)


class ScaleAdversarial:
    """Owns the discriminator and its optimizer."""

    def __init__(self, paras):
        self.paras = paras
        self.gan_type = paras.gan_type
        self.gan_k = int(paras.gan_k)
        self.wgan_clip_value = paras.wgan_clip_value
        self.discriminator = build_discriminator(paras)
        self.opt: Optional[Optimizer] = None
        # the optimizer's reduction of the flat gradient over the ranks of
        # a data axis (None: one process)
        self.reduce = None

    @property
    def map_chw(self):
        """The CNN discriminator's last map (its flatten order in the
        JAX layout), None for the Swin one."""
        d = self.discriminator
        return d.map_chw if isinstance(d, CNNDiscriminator) else None

    def init(self, device, generator: Optional[torch.Generator] = None):
        """Initialize the discriminator (seeded: dense kernels truncated
        normal std 0.02, the BasicBlock convs lecun_normal, the Swin
        blocks' convs uniform within sqrt(1 / fan_in), biases 0, norms one
        and zero) on ``device`` and make its optimizer."""
        d = self.discriminator.to("cpu")  # the same draw on any device
        init_discriminator(d, generator or torch.Generator().manual_seed(1))
        d.to(device)
        self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh optimizer state (count 0) for the current parameters."""
        from rdst_tpu_torch.config import ParametersLoader

        paras = (ParametersLoader.from_dict(GP_ADAM) if "GP" in self.gan_type
                 else self.paras)
        self.params = [p for p in self.discriminator.parameters()]
        self.opt = Optimizer(self.params, paras, self.reduce)

    def gp_alpha(self, n: int, k: int, generator=None) -> torch.Tensor:
        """The gradient penalty's interpolation weights of update ``k``,
        (n, 1, 1, 1) uniform draws (a test hands in the JAX draw here)."""
        dev = self.params[0].device
        return torch.rand((n, 1, 1, 1), generator=generator, device=dev)

    def _d_losses(self, fake, real, scales):
        d = self.discriminator
        d_fake = d(fake, train=True)
        d_real = d(real, train=True)
        if "ScaleGAN" in self.gan_type:
            loss_real = torch.mean(torch.abs(d_real - 1.0))
            loss_fake = torch.mean(torch.abs(d_fake - 1.0 / scales))
        elif "WGAN" in self.gan_type:
            loss_fake = torch.mean(d_fake)
            loss_real = -torch.mean(d_real)
        elif "RaGAN" in self.gan_type:
            loss_fake = _bce_logits(d_fake - torch.mean(d_real),
                                    torch.zeros_like(d_fake))
            loss_real = _bce_logits(d_real - torch.mean(d_fake),
                                    torch.ones_like(d_real))
        else:
            loss_fake = _bce_logits(d_fake, torch.zeros_like(d_fake))
            loss_real = _bce_logits(d_real, torch.ones_like(d_real))
        return loss_fake, loss_real

    def _gradient_penalty(self, fake, real, k: int, generator):
        alpha = self.gp_alpha(fake.shape[0], k, generator)
        hat = (fake * (1 - alpha) + real * alpha).requires_grad_(True)
        out = self.discriminator(hat, train=False)
        g = torch.autograd.grad(out.sum(), hat, create_graph=True)[0]
        gnorm = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1)
                           + 1e-12)
        return 10.0 * torch.mean((gnorm - 1.0) ** 2)

    def d_step(self, fake, real, scales=None,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """``gan_k`` guarded discriminator updates; returns the report
        (``Adv_D``, ``Adv_D Real``, ``Adv_D Fake``, means over the
        updates) as device tensors."""
        fake = fake.detach()
        real = real.detach()
        stats = list(self.discriminator.buffers())
        tot_d = tot_real = tot_fake = 0.0
        for k in range(self.gan_k):
            old_stats = [b.clone() for b in stats]
            loss_fake, loss_real = self._d_losses(fake, real, scales)
            loss_d = loss_fake + loss_real
            if "GP" in self.gan_type:
                loss_d = loss_d + self._gradient_penalty(fake, real, k,
                                                         generator)
            grads = torch.autograd.grad(loss_d, self.params,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.params, grads)]
            loss_d = loss_d.detach()
            ok = torch.isfinite(loss_d) & tree_finite(grads)
            self.opt.step(grads, ok)
            with torch.no_grad():
                for b, old in zip(stats, old_stats):
                    b.copy_(torch.where(ok, b, old))
                if self.gan_type == "WGAN":
                    c = float(self.wgan_clip_value)
                    for p in self.params:
                        p.clamp_(-c, c)
            tot_d = tot_d + loss_d
            tot_real = tot_real + loss_real.detach()
            tot_fake = tot_fake + loss_fake.detach()
        return {"Adv_D": tot_d / self.gan_k,
                "Adv_D Real": tot_real / self.gan_k,
                "Adv_D Fake": tot_fake / self.gan_k}

    def g_loss(self, fake, real=None, scales=None) -> torch.Tensor:
        d = self.discriminator
        d_fake = d(fake, train=False)
        if "RaGAN" in self.gan_type:
            d_real = d(real.detach(), train=False)
            return 0.5 * (
                _bce_logits(d_fake - torch.mean(d_real),
                            torch.ones_like(d_fake))
                + _bce_logits(d_real - torch.mean(d_fake),
                              torch.zeros_like(d_real)))
        if "WGAN" in self.gan_type:
            return -torch.mean(d_fake)
        if "ScaleGAN" in self.gan_type:
            return torch.mean(torch.abs(1.0 - d_fake))
        return _bce_logits(d_fake, torch.ones_like(d_fake))

    def generator_loss(self, pred, target, batch=None) -> torch.Tensor:
        """The registry's term: :meth:`g_loss` on the batch's scales."""
        scales = batch.get("sr_scales") if batch else None
        return self.g_loss(pred, target, scales)

    def state_dict(self) -> dict:
        return {"discriminator": self.discriminator.state_dict(),
                "optimizer": self.opt.state_dict()}

    def load_state_dict(self, d: dict) -> None:
        self.discriminator.load_state_dict(d["discriminator"])
        self.opt.load_state_dict(d["optimizer"])
