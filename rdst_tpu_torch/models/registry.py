"""Model factory (counterpart of ``rdst_tpu/models/registry.py``).

The port builds ``'rdst'`` and ``'swinir'`` (alias ``'swin'``, as in the
JAX package); every other ``feature_generator`` of the JAX package raises
and names the slice that will bring it.
"""

from __future__ import annotations

import torch

_ALIASES = {"swin": "swinir"}


def build_generator(paras, mean=None, std=None, dtype=torch.float32):
    """Build the generator a config names (``feature_generator``, or the
    sota trainer's ``sr_generator``) as an ``nn.Module`` mapping NHWC LR
    to HR."""
    raw = paras.get("feature_generator") or paras.get("sr_generator")
    name = str(raw).strip().lower()
    name = _ALIASES.get(name, name)
    if name == "rdst":
        from rdst_tpu_torch.models.rdst import make_rdst

        return make_rdst(paras, mean, std, dtype)
    if name == "swinir":
        from rdst_tpu_torch.models.swinir import make_swinir

        return make_swinir(paras, mean, std, dtype)
    raise NotImplementedError(
        f"feature_generator {raw!r} is not ported yet; it comes with the "
        "model-zoo slice of the port (the port builds 'rdst' and 'swinir')")
