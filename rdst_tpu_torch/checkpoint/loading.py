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
import warnings
from os.path import exists
from typing import Optional, Sequence, Tuple

import numpy as np
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


# the slope both packages apply for a PReLU (torch's init)
PRELU_SLOPE = 0.25


def _torch_params(model: torch.nn.Module, paras, path: str, mean,
                  std) -> dict:
    """A reference torch checkpoint of ``model``'s family as the port's
    state_dict (numpy): the family's key mapper
    (``checkpoint.torch_import``) into the flax tree, checked leaf by leaf
    against the model's own tree (a missing, extra or misshaped leaf
    raises and names it), then carried over by ``convert.export_params``.
    The file's MeanShift entries are rebuilt from ``mean`` / ``std`` (the
    model's own normalization) and its window buffers from the geometry; its PReLU
    slopes are dropped, as the JAX import drops them (both packages apply
    the fixed 0.25), with a warning that counts those that differ."""
    from rdst_tpu_torch.checkpoint import torch_import as ti
    from rdst_tpu_torch.checkpoint.convert import export_params
    from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict

    generator = paras.get("feature_generator") or paras.get("sr_generator")
    arch = ti.mapper_arch(generator)
    # no mapper in the JAX package either: MetaSR, ESTSR, the wavelet
    # transformers, Swin-MLP and RDST-N (an RDST with a global bottleneck)
    if arch not in ti._MAPPERS or (
            arch == "rdst" and paras.get("rdst_global_bottleneck")):
        raise NotImplementedError(
            f"{path}: no reference torch key mapper for "
            f"{'RDST-N' if arch == 'rdst' else repr(generator)} (the JAX "
            "package has none either); use the .msgpack snapshot")
    kw = ti.mapper_kwargs(paras, arch)
    sd = read_torch_state_dict(path)
    slopes = ti.prelu_slopes(sd, arch, **kw)
    off = sorted(k for k, v in slopes.items()
                 if np.any(np.asarray(v) != PRELU_SLOPE))
    if off:
        warnings.warn(
            f"{path}: {len(off)} of {len(slopes)} PReLU slopes differ from "
            f"{PRELU_SLOPE} ({off[:3]}...); they are dropped, as the JAX "
            f"package drops them: both apply the fixed slope {PRELU_SLOPE}")
    tree = ti.convert_state_dict(sd, arch, **kw)
    ti.verify_params_match(tree, import_state_dict(model.state_dict()))
    return export_params(tree, generator, mean, std)


def load_well_trained_params(model: torch.nn.Module, paras, path: str,
                             sr_scales: Sequence[float]) -> torch.nn.Module:
    """Load a trained generator's weights into ``model`` (strictly: every
    key must match) and return it.

    A ``.msgpack`` snapshot (of any generator the port builds) is read
    without flax (``checkpoint.msgpack_reader``) and carried over by
    ``checkpoint.convert``. A reference torch checkpoint (``.pt``,
    ``.pth``, ``.tar``) of a family that ``checkpoint.torch_import`` maps
    goes through its mapper first (:func:`_torch_params`). RDST's
    MeanShift entries come from the model's own normalization in both
    cases. A ``.pt`` path whose ``.msgpack`` sibling exists takes the
    sibling, as in the JAX package."""
    from rdst_tpu_torch.checkpoint.convert import export_params
    from rdst_tpu_torch.checkpoint.msgpack_reader import read_snapshot

    stem, ext = os.path.splitext(path)
    if ext == ".pt" and not exists(path) and exists(stem + ".msgpack"):
        path, ext = stem + ".msgpack", ".msgpack"
    generator = paras.get("feature_generator") or paras.get("sr_generator")
    mean, std = getattr(model, "mean", (0.0,)), getattr(model, "std", (1.0,))
    if ext in (".pt", ".tar", ".pth"):
        sd = _torch_params(model, paras, path, mean, std)
    elif ext == ".msgpack":
        sd = export_params(read_snapshot(path), generator, mean, std)
    else:
        raise ValueError(f"unknown checkpoint format: {path}")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model
