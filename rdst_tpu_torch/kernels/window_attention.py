"""Kernel-mode resolution (counterpart of
``rdst_tpu/kernels/window_attention.py``: ``pallas_mode``,
``export_kernel_flags``), with env names of the port's own. The config
keys keep their meaning:

``pallas_kernels`` -> ``RDST_TORCH_KERNELS``  (rdstb/pair/swin/pack/off)
``pallas_quant``   -> ``RDST_TORCH_QUANT``    (int8 groups, or off)
``pallas_softmax`` -> ``RDST_TORCH_SOFTMAX``  (auto/stable/clamp/...)
``pallas_train``   -> ``RDST_TORCH_TRAIN``    (pair/block/off: the bf16
                                              training route, :func:`train_flag`)

The JAX package exports a config's keys to its env flags, and the blocks
read them at trace time, which freezes the choice into the compiled
program. An eager PyTorch model would re-read them on every forward, so
the port resolves them once, when a model is built (:func:`kernel_flags`),
and keeps the result on the model; nothing here writes the environment.
A key present in the config wins over the env flag, which wins over the
default.

What a mode runs depends on the model's dtype (``models.rdst
.set_kernel_mode`` applies it once, when the model is built):

* float32: every kernel mode (``rdstb``, ``pair``, ``swin``, ``pack``,
  and the default) means the f32 single-block kernel
  ``kernels.swin_block.fused_swin_block``;
* bfloat16: ``rdstb`` (the default) runs one ``kernels.rdstb_block``
  launch per RDSTB, ``pair`` one ``kernels.swin_pair`` launch per DSTL,
  ``swin`` the fast block kernel per Swin block, and ``pack`` the same
  fast block kernel: the JAX package's ``pack=2`` puts two windows in
  one lane row of the TPU, a layout with the same arithmetic.

``off`` asks for the plain PyTorch path in either dtype. ``pallas_quant
='qkv'`` runs the fast block's qkv product on int8 operands in bf16
(``kernels.quant``); float32 drops int8, as the JAX precise path does, and
the other groups raise (not ported). The softmax
variant (resolved once; ``auto`` against the checkpoint's stamp) selects
the bf16 kernels' stabilizer: ``''``/``stable``/``stable_bc`` (exact,
the per-head row max subtracted), ``stable_mm`` (the max rounded to
bf16), ``clamp`` (exp(min(s, 60)), no max); the f32 kernel always runs
the exact max-subtracted softmax.
"""

from __future__ import annotations

import os
from typing import NamedTuple

ENV_KERNELS = "RDST_TORCH_KERNELS"
ENV_QUANT = "RDST_TORCH_QUANT"
ENV_SOFTMAX = "RDST_TORCH_SOFTMAX"
ENV_TRAIN = "RDST_TORCH_TRAIN"

KERNEL_MODES = ("rdstb", "pair", "swin", "pack")
QUANT_GROUPS = ("qkv", "mlp", "proj", "conv")
SOFTMAX_VARIANTS = ("auto", "stable", "clamp", "stable_mm", "stable_bc")
_OFF = ("", "none", "off", "false", "xla", "0")


class KernelFlags(NamedTuple):
    kernels: str        # one of KERNEL_MODES, or '' for the plain path
    quant: frozenset    # int8 matmul groups (empty: none)
    softmax: str        # a SOFTMAX_VARIANTS entry, or '' for the default


def _lookup(paras, key: str, env: str):
    """(value, from_config): the config's key when present, else the env."""
    val = paras.get(key) if hasattr(paras, "get") else None
    if val is not None:
        return str(val).strip().lower(), True
    return os.environ.get(env, "").strip().lower(), False


def pallas_mode(raw: str, from_config: bool = False) -> str:
    """'rdstb' (the default when unset), 'pair', 'swin' or 'pack' (what
    each runs: the module docstring), or '' for the plain path. An empty config
    value means off, an empty env flag the default; an unknown mode
    raises rather than running something else."""
    if raw in _OFF and (raw or from_config):
        return ""
    mode = raw or "rdstb"
    if mode not in KERNEL_MODES:
        raise ValueError(f"pallas_kernels={raw!r}: expected one of "
                         f"{KERNEL_MODES} or off")
    return mode


def quant_flags(raw: str) -> frozenset:
    """Comma list of int8 matmul groups (qkv, mlp, proj, conv; 'all' =
    all four); empty for ''/'0'/'none'/'off'."""
    raw = raw.strip().lower()
    if raw in _OFF:
        return frozenset()
    if raw == "all":
        return frozenset(QUANT_GROUPS)
    flags = frozenset(p.strip() for p in raw.split(",") if p.strip())
    bad = flags - set(QUANT_GROUPS)
    if bad:
        raise ValueError(f"pallas_quant: unknown groups {sorted(bad)}")
    return flags


def kernel_flags(paras) -> KernelFlags:
    """Resolve a config's kernel keys once (config, then env, then the
    default); raises on a value it does not know."""
    kernels = pallas_mode(*_lookup(paras, "pallas_kernels", ENV_KERNELS))
    quant = quant_flags(_lookup(paras, "pallas_quant", ENV_QUANT)[0])
    softmax = _lookup(paras, "pallas_softmax", ENV_SOFTMAX)[0]
    if softmax in ("", "none", "default"):
        softmax = ""
    elif softmax not in SOFTMAX_VARIANTS:
        raise ValueError(
            f"pallas_softmax={softmax!r}: expected one of {SOFTMAX_VARIANTS}")
    return KernelFlags(kernels, quant, softmax)


def train_flag(paras) -> str:
    """``pallas_train`` resolved once (config, then env): 'pair' (the
    default, as the JAX trainer turns it on for bf16 training) runs each
    layer of a bf16 training step on the train-pair kernels where the JAX
    package's rule admits its pairs, else on the single-block train
    kernel; 'block' runs every block on the single-block kernel (the JAX
    package's forced A/B); '' the plain modules under autograd
    (``models.routes.set_train_mode``); anything else raises."""
    raw, from_config = _lookup(paras, "pallas_train", ENV_TRAIN)
    if raw in _OFF and (raw or from_config):
        return ""
    mode = raw or "pair"
    if mode not in ("pair", "block"):
        raise ValueError(f"pallas_train={raw!r}: expected 'pair', 'block' "
                         "or off")
    return mode
