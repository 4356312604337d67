"""Well-trained checkpoint loading (counterpart of
``rdst_tpu/checkpoint/loading.py``): the model path with the reference's
key precedence, the ``.stats.json`` sidecar, the ``pallas_softmax='auto'``
resolution (returned, not written to the environment), and the
``.msgpack`` branch of ``load_well_trained_params``.
"""

from __future__ import annotations

import json
import os
from os.path import exists
from typing import Optional, Sequence, Tuple

import torch


def resolve_model_path(paras) -> Optional[str]:
    """Explicit single-scale first, then the MetaSR/MDSR family keys,
    then the per-scale x4 fallback."""
    return (paras.get("well_trained_single_scale_model_g")
            or paras.get("well_trained_model_metasr")
            or paras.get("well_trained_model_mdsr")
            or paras.get("well_trained_model_g_x4"))


def read_stats_sidecar(model_path: Optional[str]) -> Optional[dict]:
    """The ``<snapshot>.stats.json`` sidecar (normalization stats and the
    audited ``attn_logit_max``); None when absent."""
    if not model_path:
        return None
    sidecar = os.path.splitext(model_path)[0] + ".stats.json"
    if not exists(sidecar):
        return None
    with open(sidecar) as f:
        return json.load(f)


def resolve_norm_stats(paras, model_path: Optional[str]) -> Tuple[list, list]:
    """Training-set mean/std for zero_mean/unit_std configs, from the
    stats sidecar. Recomputing them from the training volumes (the JAX
    package's fallback for old snapshots) needs the data readers, which
    come with the tester slice."""
    stats = read_stats_sidecar(model_path)
    if stats is not None and "mean" in stats:
        return stats["mean"], stats["std"]
    raise NotImplementedError(
        f"no stats sidecar with mean/std beside {model_path!r}: recomputing "
        "them from the training volumes comes with the port's tester slice")


def resolve_pallas_softmax(model_path: Optional[str], mode: str) -> str:
    """Resolve ``pallas_softmax='auto'`` against the checkpoint's audited
    logit bound; any other ``mode`` comes back as it is."""
    from rdst_tpu_torch.kernels.swin_block import resolve_softmax_auto

    if mode != "auto":
        return mode
    stats = read_stats_sidecar(model_path) or {}
    return resolve_softmax_auto(stats.get("attn_logit_max"))


def load_well_trained_params(model: torch.nn.Module, paras, path: str,
                             sr_scales: Sequence[float]) -> torch.nn.Module:
    """Load a trained generator's weights into ``model`` (strictly: every
    key must match) and return it.

    A ``.msgpack`` snapshot is read without flax
    (``checkpoint.msgpack_reader``) and carried over by
    ``checkpoint.convert``; the MeanShift entries come from the model's
    own normalization. A ``.pt`` path whose ``.msgpack`` sibling exists
    takes the sibling, as in the JAX package; reference torch checkpoints
    themselves come with a later slice."""
    from rdst_tpu_torch.checkpoint.convert import export_rdstsr
    from rdst_tpu_torch.checkpoint.msgpack_reader import read_snapshot

    stem, ext = os.path.splitext(path)
    if ext == ".pt" and not exists(path) and exists(stem + ".msgpack"):
        path, ext = stem + ".msgpack", ".msgpack"
    if ext in (".pt", ".tar", ".pth"):
        raise NotImplementedError(
            f"{path}: reference torch checkpoints (.pt/.pth/.tar) come with "
            "the port's torch-import slice")
    if ext != ".msgpack":
        raise ValueError(f"unknown checkpoint format: {path}")
    if str(paras.get("feature_generator")).strip().lower() != "rdst":
        raise NotImplementedError(
            "only RDST snapshots are carried over in this slice")
    sd = export_rdstsr(read_snapshot(path), model.mean, model.std)
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model
