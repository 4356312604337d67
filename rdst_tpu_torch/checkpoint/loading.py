"""Well-trained checkpoint loading (counterpart of
``rdst_tpu/checkpoint/loading.py``): the model path with the reference's
key precedence, the ``.stats.json`` sidecar, the ``pallas_softmax='auto'``
resolution (returned, not written to the environment), the training-set
normalization of zero_mean/unit_std configs, and
``load_well_trained_params`` for ``.msgpack`` snapshots and reference
torch state dicts (``.pt``/``.pth``/``.tar``).
"""

from __future__ import annotations

import json
import os
import pickle
import re
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
    """Training-set mean/std for zero_mean/unit_std configs: from the
    stats sidecar when there is one, else recomputed from the training
    volumes the config names (old snapshots), as the JAX package does."""
    stats = read_stats_sidecar(model_path)
    if stats is not None and "mean" in stats:
        return stats["mean"], stats["std"]
    from rdst_tpu_torch.data.readers import make_train_valid_datasets

    ds_train, _ = make_train_valid_datasets(paras)
    return ds_train.mean, ds_train.std


def resolve_pallas_softmax(model_path: Optional[str], mode: str) -> str:
    """Resolve ``pallas_softmax='auto'`` against the checkpoint's audited
    logit bound; any other ``mode`` comes back as it is."""
    from rdst_tpu_torch.kernels.swin_block import resolve_softmax_auto

    if mode != "auto":
        return mode
    stats = read_stats_sidecar(model_path) or {}
    return resolve_softmax_auto(stats.get("attn_logit_max"))


# entries a reference checkpoint carries that the port rebuilds: the
# MeanShift convs (from the model's own normalization) and the window
# buffers (closed form), as ``rdst_tpu/checkpoint/torch_import.py`` skips them
_REBUILT = re.compile(r"^(sub_mean|add_mean)\.|(^|\.)(relative_position_index"
                      r"|attn_mask)$")


def read_torch_state_dict(path: str) -> dict:
    """The tensors of a reference torch checkpoint: a state dict, or one
    wrapped as ``{'state_dict': ...}``. Read with ``weights_only=True``:
    a pickled whole module would need the reference's classes, and
    raises."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a plain state dict (a pickled module needs the "
            "reference's classes to load); save model.state_dict() "
            f"instead. Underlying error: {e}") from e
    if isinstance(sd, dict) and "state_dict" in sd and not hasattr(
            sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(sd)}")
    return sd


def load_well_trained_params(model: torch.nn.Module, paras, path: str,
                             sr_scales: Sequence[float]) -> torch.nn.Module:
    """Load a trained generator's weights into ``model`` (strictly: every
    key must match) and return it.

    A ``.msgpack`` snapshot (RDST or SwinIR) is read without flax
    (``checkpoint.msgpack_reader``) and carried over by
    ``checkpoint.convert``. A reference torch checkpoint (``.pt``,
    ``.pth``, ``.tar``) already has the port's keys; its MeanShift and
    window-index entries are dropped and rebuilt. RDST's MeanShift
    entries come from the model's own normalization in both cases. A
    ``.pt`` path whose ``.msgpack`` sibling exists takes the sibling, as
    in the JAX package."""
    from rdst_tpu_torch.checkpoint.convert import (export_params,
                                                   mean_shift_entries)
    from rdst_tpu_torch.checkpoint.msgpack_reader import read_snapshot

    stem, ext = os.path.splitext(path)
    if ext == ".pt" and not exists(path) and exists(stem + ".msgpack"):
        path, ext = stem + ".msgpack", ".msgpack"
    generator = paras.get("feature_generator") or paras.get("sr_generator")
    mean, std = getattr(model, "mean", (0.0,)), getattr(model, "std", (1.0,))
    if ext in (".pt", ".tar", ".pth"):
        sd = {k: v for k, v in read_torch_state_dict(path).items()
              if not _REBUILT.search(k)}
        if str(generator).strip().lower() == "rdst":
            sd.update({k: torch.from_numpy(v)
                       for k, v in mean_shift_entries(mean, std).items()})
        model.load_state_dict(sd)
        return model
    if ext != ".msgpack":
        raise ValueError(f"unknown checkpoint format: {path}")
    sd = export_params(read_snapshot(path), generator, mean, std)
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model
