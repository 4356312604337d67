"""Model factory (counterpart of ``rdst_tpu/models/registry.py``).

The port builds every name of the JAX registry's ``BUILTIN_GENERATORS``:
``'rdst'`` (RDST-N with ``rdst_global_bottleneck``), ``'estsr'``,
``'swinir'`` (alias ``'swin'``, as in the JAX package), the wavelet
transformers ``'wtb'`` / ``'wtr'`` / ``'wtp'`` / ``'wts'``, ``'swinmlp'``
/ ``'swin-mlp'``, and the convolutional families ``'edsr'``,
``'metasr'``, ``'srresnet'``, ``'srdensenet'``, ``'rdn'``, ``'esrgan'``,
``'mdsr'``, ``'rcan'``, ``'han'``, ``'convnet-large'`` /
``'convnet-lite'``, ``'dbpn'``, ``'zssr'`` and ``'ipt'``. Any other name
raises ``ValueError``.
"""

from __future__ import annotations

import importlib

import torch

_ALIASES = {"swin": "swinir", "swin-mlp": "swinmlp"}
# name: (module under rdst_tpu_torch.models, factory)
_FACTORIES = {
    "rdst": ("rdst", "make_rdst"),
    "estsr": ("estsr", "make_estsr"),
    "swinir": ("swinir", "make_swinir"),
    "edsr": ("edsr", "make_edsr"),
    "metasr": ("metasr", "make_metasr"),
    "srresnet": ("srresnet", "make_srresnet"),
    "srdensenet": ("srdensenet", "make_srdensenet"),
    "rdn": ("rdn", "make_rdn"),
    "esrgan": ("esrgan", "make_esrgan"),
    "mdsr": ("mdsr", "make_mdsr"),
    "rcan": ("rcan", "make_rcan"),
    "han": ("han", "make_han"),
    "convnet-large": ("convnext_sr", "make_convnet_large"),
    "convnet-lite": ("convnext_sr", "make_convnet_lite"),
    "dbpn": ("dbpn", "make_dbpn"),
    "zssr": ("zssr", "make_zssr"),
    "ipt": ("ipt", "make_ipt"),
    "swinmlp": ("swin_mlp", "make_swinmlp"),
    **{name: ("wavelet_sr", "make_wavelet_sr")
       for name in ("wtb", "wtr", "wtp", "wts")},
}


def build_generator(paras, mean=None, std=None, dtype=torch.float32):
    """Build the generator a config names (``feature_generator``, or the
    sota trainer's ``sr_generator``) as an ``nn.Module`` mapping NHWC LR
    to HR: ``model(x, sr_scale=None)``, the scale read by the models whose
    branch or output size depends on it (MetaSR, a scale-free RDST or
    EDSR, MDSR, IPT), which need it."""
    raw = paras.get("feature_generator") or paras.get("sr_generator")
    name = str(raw).strip().lower()
    name = _ALIASES.get(name, name)
    if name not in _FACTORIES:
        raise ValueError(f"unknown feature_generator {raw!r}; the port "
                         f"builds {sorted(_FACTORIES)}")
    module, factory = _FACTORIES[name]
    make = getattr(importlib.import_module(f"rdst_tpu_torch.models.{module}"),
                   factory)
    return make(paras, mean, std, dtype)
