"""SR loss registry with multi-stage scalars (counterpart of
``rdst_tpu/losses/sr_loss.py``), in PyTorch.

Built from ``training_losses`` with per-training-state scalars from
``loss_scalars``: the pixel terms L1 and L2/MSE, the VGG terms
(``VGG22``/``VGG54``/``Minc_VGG*``, ``losses.vgg.VGGLoss``), the
adversarial term (any ``*GAN*`` name; ``self.adversarial`` owns the
discriminator, which the trainer updates) and the seg-UNet term
``'UNet-F'``. ``loss(pred, batch, state)`` returns the weighted total and
a report of each term, as tensors; every term is ``term(pred, target,
batch)``. Per-state records stay on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from rdst_tpu_torch.metrics.evaluation import tabulate


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


class SRLoss:
    """Loss terms from a config, callable per training state."""

    def __init__(self, paras):
        self.loss_scalars: Dict[str, Dict[str, float]] = {
            state: dict(scalars)
            for state, scalars in paras.loss_scalars.items()}
        self.training_states = list(paras.training_states)
        self.current_state = self.training_states[0]
        self.terms: Dict[str, Callable] = {}
        self.adversarial = None
        self.records: Dict[str, Dict[str, list]] = {
            s: {} for s in self.training_states}
        for name in paras.training_losses:
            if name == "L1":
                self.terms[name] = lambda p, t, b=None: l1_loss(p, t)
            elif name in ("L2", "MSE"):
                self.terms[name] = lambda p, t, b=None: l2_loss(p, t)
            elif name.startswith(("VGG", "Minc_VGG")):
                from rdst_tpu_torch.losses.vgg import VGGLoss

                self.terms[name] = VGGLoss(name)
            elif "GAN" in name:
                from rdst_tpu_torch.losses.adversarial import ScaleAdversarial

                self.adversarial = ScaleAdversarial(paras)
                self.terms[name] = self.adversarial.generator_loss
            elif name == "UNet-F":
                from rdst_tpu_torch.losses.seg_unet import SegUNetLoss

                self.terms[name] = SegUNetLoss(paras)
            else:
                raise ValueError(f"unsupported loss term: {name}")

    def to(self, device) -> "SRLoss":
        """Move the terms' frozen networks (the discriminator moves at
        ``adversarial.init``)."""
        for term in self.terms.values():
            if isinstance(term, torch.nn.Module):
                term.to(device)
        return self

    def set_training_state(self, state: str):
        if state not in self.loss_scalars:
            raise ValueError(f"unknown training state {state}")
        self.current_state = state

    def active_terms(self, state: Optional[str] = None):
        state = state or self.current_state
        return {n: s for n, s in self.loss_scalars[state].items()
                if n in self.terms}

    def __call__(self, pred, batch, state: Optional[str] = None):
        """Weighted sum over the state's terms: (total, {name: value})."""
        state = state or self.current_state
        total = pred.new_zeros((), dtype=torch.float32)
        report = {}
        for name, scalar in self.loss_scalars[state].items():
            value = self.terms[name](pred, batch["out"], batch)
            total = total + scalar * value
            report[name] = value
        return total, report

    def record(self, report: Dict[str, float], state: Optional[str] = None):
        state = state or self.current_state
        rec = self.records.setdefault(state, {})
        for name, value in report.items():
            rec.setdefault(name, []).append(float(value))

    def print_records(self) -> str:
        rows = []
        names = sorted({n for recs in self.records.values() for n in recs})
        for state in self.training_states:
            recs = self.records.get(state, {})
            rows.append([state] + [
                "{:.4}".format(float(np.mean(recs[n]))) if recs.get(n)
                else "-" for n in names])
        return tabulate(rows, headers=["state"] + names)

    def state_dict(self) -> dict:
        return {"records": self.records, "current_state": self.current_state}

    def load_state_dict(self, d: dict):
        self.records = d.get("records", self.records)
        self.current_state = d.get("current_state", self.current_state)
