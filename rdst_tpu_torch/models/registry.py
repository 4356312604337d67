"""Model factory (counterpart of ``rdst_tpu/models/registry.py``).

This slice ports ``'rdst'`` only; every other ``feature_generator`` of
the JAX package raises and names the slice that will bring it.
"""

from __future__ import annotations

import torch

LATER_SLICES = {
    "swinir": "the SwinIR slice", "swin": "the SwinIR slice",
}


def build_generator(paras, mean=None, std=None, dtype=torch.float32):
    """Build the generator a config names (``feature_generator``, or the
    sota trainer's ``sr_generator``) as an ``nn.Module`` mapping NHWC LR
    to HR."""
    raw = paras.get("feature_generator") or paras.get("sr_generator")
    name = str(raw).strip().lower()
    if name == "rdst":
        from rdst_tpu_torch.models.rdst import make_rdst

        return make_rdst(paras, mean, std, dtype)
    later = LATER_SLICES.get(name, "the model-zoo slice")
    raise NotImplementedError(
        f"feature_generator {raw!r} is not ported yet; it comes with "
        f"{later} of the port (this slice serves 'rdst')")
