"""Model factory (counterpart of ``rdst_tpu/models/registry.py``).

The port builds ``'rdst'`` (RDST-N with ``rdst_global_bottleneck``),
``'estsr'``, ``'swinir'`` (alias ``'swin'``, as in the JAX package),
``'edsr'``, ``'metasr'``, the wavelet transformers ``'wtb'`` / ``'wtr'``
/ ``'wtp'`` / ``'wts'`` and ``'swinmlp'`` / ``'swin-mlp'``; the
convolutional families of the JAX package raise and name the roadmap
item that will bring them.
"""

from __future__ import annotations

import torch

_ALIASES = {"swin": "swinir", "swin-mlp": "swinmlp"}
_WAVELET = ("wtb", "wtr", "wtp", "wts")
# the JAX registry's generators the port does not build yet
UNPORTED = ("rdn", "rcan", "han", "convnet-large", "convnet-lite",
            "srresnet", "srdensenet", "esrgan", "mdsr", "ipt", "dbpn",
            "zssr")


def _factory(name: str):
    if name == "rdst":
        from rdst_tpu_torch.models.rdst import make_rdst as make
    elif name == "estsr":
        from rdst_tpu_torch.models.estsr import make_estsr as make
    elif name == "swinir":
        from rdst_tpu_torch.models.swinir import make_swinir as make
    elif name == "edsr":
        from rdst_tpu_torch.models.edsr import make_edsr as make
    elif name == "metasr":
        from rdst_tpu_torch.models.metasr import make_metasr as make
    elif name in _WAVELET:
        from rdst_tpu_torch.models.wavelet_sr import make_wavelet_sr as make
    elif name == "swinmlp":
        from rdst_tpu_torch.models.swin_mlp import make_swinmlp as make
    else:
        return None
    return make


def build_generator(paras, mean=None, std=None, dtype=torch.float32):
    """Build the generator a config names (``feature_generator``, or the
    sota trainer's ``sr_generator``) as an ``nn.Module`` mapping NHWC LR
    to HR: ``model(x, sr_scale=None)``, the scale read by scale-free
    models, which need it."""
    raw = paras.get("feature_generator") or paras.get("sr_generator")
    name = str(raw).strip().lower()
    name = _ALIASES.get(name, name)
    make = _factory(name)
    if make is None and name not in UNPORTED:
        raise ValueError(f"unknown feature_generator {raw!r}")
    if make is None:
        raise NotImplementedError(
            f"feature_generator {raw!r} is not ported: the convolutional "
            f"families ({', '.join(UNPORTED)}) come with the rest of the "
            "model zoo (ROADMAP Queue A 8)")
    return make(paras, mean, std, dtype)
