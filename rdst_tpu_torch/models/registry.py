"""Model factory (counterpart of ``rdst_tpu/models/registry.py``).

The port builds ``'rdst'``, ``'swinir'`` (alias ``'swin'``, as in the
JAX package), ``'edsr'`` and ``'metasr'``; every other
``feature_generator`` of the JAX package raises and names the roadmap
item that will bring it.
"""

from __future__ import annotations

import torch

_ALIASES = {"swin": "swinir"}


def build_generator(paras, mean=None, std=None, dtype=torch.float32):
    """Build the generator a config names (``feature_generator``, or the
    sota trainer's ``sr_generator``) as an ``nn.Module`` mapping NHWC LR
    to HR: ``model(x, sr_scale=None)``, the scale read by scale-free
    models, which need it."""
    raw = paras.get("feature_generator") or paras.get("sr_generator")
    name = str(raw).strip().lower()
    name = _ALIASES.get(name, name)
    if name == "rdst":
        from rdst_tpu_torch.models.rdst import make_rdst

        return make_rdst(paras, mean, std, dtype)
    if name == "swinir":
        from rdst_tpu_torch.models.swinir import make_swinir

        return make_swinir(paras, mean, std, dtype)
    if name == "edsr":
        from rdst_tpu_torch.models.edsr import make_edsr

        return make_edsr(paras, mean, std, dtype)
    if name == "metasr":
        from rdst_tpu_torch.models.metasr import make_metasr

        return make_metasr(paras, mean, std, dtype)
    raise NotImplementedError(
        f"feature_generator {raw!r} is not ported (of the model-zoo "
        "families the port builds 'rdst', 'swinir', 'edsr' and 'metasr'; "
        "the rest is ROADMAP Queue A 8)")
