"""Parameters -> reference torch state_dict (the port's counterpart of
``rdst_tpu/checkpoint/torch_export.py``): the inverse of
``checkpoint.torch_import``.

* :func:`export_from_template` inverts any family's import mapper by
  tracing: each template key runs through the mapper with an ``arange``
  index array, and where the indices land in the flax tree says which
  flax element fills which torch element.
* :func:`save_torch_checkpoint` writes a reference ``.pt`` from a flax
  tree (numpy, as ``checkpoint.msgpack_reader`` returns it) or from a
  port module. RDST and SwinIR need no template: the port's state_dict
  is their reference layout. Every other family needs one.
* :func:`reference_template` gives that template for a built port model:
  the reference network's keys and shapes, written from the mappers'
  regexes (the reference networks are not part of this repository).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from rdst_tpu_torch.checkpoint.convert import (export_rdstsr, export_swinir,
                                               mean_shift_entries)
from rdst_tpu_torch.checkpoint.torch_import import _MAPPERS, _flatten


def export_from_template(params, arch: str, template, *,
                         mean=(0.0,), std=(1.0,),
                         **mapper_kwargs) -> Dict[str, np.ndarray]:
    """Generic flax -> torch export for ANY family with an import map.

    ``template`` maps torch key -> tensor or shape tuple (the reference
    model's ``state_dict()``, a same-architecture ``.pt``, or
    :func:`reference_template`). Keys the import deliberately skips are
    rebuilt where closed-form (the MeanShift convs from ``mean``/``std``)
    and otherwise omitted (PReLU slopes, window buffers). Raises KeyError
    for keys the family's map cannot place and ValueError when a flax leaf
    only partially covers a torch tensor (a merge the tracer cannot
    invert)."""
    mapper = _MAPPERS[arch]
    flat = _flatten(params["params"] if "params" in params else params)
    flax_vals = {"/".join(str(s) for s in p): np.asarray(v)
                 for p, v in flat.items()}
    shift = mean_shift_entries(mean, std)
    sd: Dict[str, np.ndarray] = {}
    for key, tv in template.items():
        shape = (tuple(tv) if isinstance(tv, (tuple, list))
                 else tuple(tv.shape))
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        idx = np.arange(n, dtype=np.int64).reshape(shape)
        placed = list(mapper(key, idx, **mapper_kwargs) or ())
        if not placed:  # import skips it: closed-form or torch-side buffer
            if key in shift:
                sd[key] = shift[key]
            continue
        out = np.empty(n, np.float32)
        filled = 0
        for path, tr in placed:
            p = "/".join(str(s) for s in path)
            if p not in flax_vals:
                raise KeyError(f"{arch} export: template key {key!r} maps "
                               f"to {p!r}, absent from the flax tree")
            fv = np.asarray(flax_vals[p], np.float32)
            tr = np.asarray(tr)
            if tr.shape != fv.shape:
                raise ValueError(
                    f"{arch} export: {key!r} -> {p!r} shape mismatch "
                    f"{tr.shape} vs {fv.shape} (partial/merged mapping)")
            out[tr.ravel()] = fv.ravel()
            filled += tr.size
        if filled != n:
            raise ValueError(f"{arch} export: {key!r} only {filled}/{n} "
                             "elements covered by the flax tree")
        sd[key] = out.reshape(shape)
    return sd


def save_torch_checkpoint(params_or_model, path: str, arch: str = "rdst",
                          mean=(0.0,), std=(1.0,), template=None,
                          **mapper_kwargs) -> None:
    """Write a reference torch state_dict ``.pt`` of a flax tree or of a
    port module (its tree by ``msgpack_writer.import_state_dict``; RDST's
    MeanShift from the module's own normalization). RDST and SwinIR have
    direct writers; every other family exports through
    :func:`export_from_template` (pass the reference state_dict, a
    key->shape mapping or :func:`reference_template` as ``template``)."""
    from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict

    params = params_or_model
    if isinstance(params_or_model, torch.nn.Module):
        if arch == "rdst":
            mean = getattr(params_or_model, "mean", mean)
            std = getattr(params_or_model, "std", std)
        params = import_state_dict(params_or_model.state_dict())
    if arch == "rdst":
        sd = export_rdstsr(params, mean, std)
    elif arch == "swinir":
        sd = export_swinir(params)
    elif template is not None:
        sd = export_from_template(params, arch, template, mean=mean,
                                  std=std, **mapper_kwargs)
    else:
        raise NotImplementedError(
            f"export for {arch!r} needs a torch-side template "
            "(state_dict or key->shape map); RDST and SwinIR also have "
            "template-free writers")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v).copy())
                for k, v in sd.items()}, path)


# -- the reference layout of a built port model ---------------------------------

# families whose reference network holds MeanShift convs (their mappers
# skip ``sub_mean`` / ``add_mean``)
_MEAN_SHIFT = ("edsr", "srresnet", "mdsr", "rdn", "srdensenet", "esrgan",
               "rcan", "han", "convnext", "ipt")

_TAIL = [  # common.py's tail Sequential, the head conv at index 0
    (r"head", lambda m, c: "head.0"),
    (r"tail_up/conv_(\d+)", lambda m, c: f"tail.0.{2 * int(m[1])}"),
    (r"tail_conv", lambda m, c: "tail.1" if c["tail_up"] else "tail"),
]
_BODY_CONV = [(r"body_conv", lambda m, c: f"body.{c['body']}")]
_DENSE = [(r"body_(\d+)/dense_(\d+)/conv",
           lambda m, c: f"body.{m[1]}.body.{m[2]}.body.0")]
_RG = [  # RCAN / HAN: residual groups of RCABs with a CALayer
    (r"body_(\d+)/rcab_(\d+)/ca/du_(\d+)",
     lambda m, c: f"body.{m[1]}.body.{m[2]}.body.3.conv_du.{2 * int(m[3])}"),
    (r"body_(\d+)/conv",
     lambda m, c: f"body.{m[1]}.body.{c['rcab'][m[1]]}"),
]
_ENC = r"body/(encoder|decoder)_(\d+)"

# arch: [(flax module path regex, reference module prefix)]; a leaf that
# is not a kernel, bias or scale is matched with its own name and gives
# the whole key
_RULES = {
    "edsr": _TAIL + _BODY_CONV + [
        (r"body_(\d+)/conv_(\d+)",
         lambda m, c: f"body.{m[1]}.body.{2 * int(m[2])}")],
    "mdsr": _BODY_CONV + [
        (r"head_(\d)", lambda m, c: f"head_{m[1]}.0"),
        (r"tail_up_(\d)/conv_(\d+)",
         lambda m, c: f"tail_{m[1]}.0.{2 * int(m[2])}"),
        (r"tail_conv_(\d)", lambda m, c: f"tail_{m[1]}.1"),
        (r"body_(\d+)/conv_(\d+)",
         lambda m, c: f"body.{m[1]}.body.{2 * int(m[2])}")],
    "rdn": _TAIL + _DENSE + [
        (r"F0", lambda m, c: "F0"),
        (r"body_(\d+)/bottleneck", lambda m, c: f"body.{m[1]}.bottle_neck"),
        (r"bottleneck_([01])", lambda m, c: f"bottleneck.{m[1]}")],
    "srdensenet": _TAIL + _DENSE + [
        (r"bottleneck", lambda m, c: "bottleneck")],
    "esrgan": _TAIL + _BODY_CONV + [
        (r"body_(\d+)/rdb_(\d+)/dense_(\d+)/conv",
         lambda m, c: f"body.{m[1]}.body.{m[2]}.body.{m[3]}.body.0"),
        (r"body_(\d+)/rdb_(\d+)/bottleneck",
         lambda m, c: f"body.{m[1]}.body.{m[2]}.bottle_neck")],
    "zssr": [
        (r"head", lambda m, c: "model.0"),
        (r"body_(\d+)", lambda m, c: f"model.{2 * (int(m[1]) + 1)}"),
        (r"tail", lambda m, c: f"model.{2 * (c['body'] + 1)}")],
    "rcan": _TAIL + _BODY_CONV + _RG + [
        (r"body_(\d+)/rcab_(\d+)/conv_(\d+)/(conv[012])",
         lambda m, c: f"body.{m[1]}.body.{m[2]}.body.{2 * int(m[3])}.{m[4]}")],
    "han": _TAIL + _BODY_CONV + _RG + [
        (r"body_(\d+)/rcab_(\d+)/conv_(\d+)",
         lambda m, c: f"body.{m[1]}.body.{m[2]}.body.{2 * int(m[3])}"),
        (r"(la|csa)/gamma", lambda m, c: f"{m[1]}.gamma"),
        (r"csa/conv3d", lambda m, c: "csa.conv"),
        (r"(last_conv|last)", lambda m, c: m[1])],
    "convnext": _TAIL + [
        (r"body_(\d+)/(dwconv|norm|pwconv1|pwconv2)",
         lambda m, c: f"body.{m[1]}.{m[2]}"),
        (r"body_(\d+)/gamma", lambda m, c: f"body.{m[1]}.gamma")],
    "dbpn": [
        (r"input_conv_([01])", lambda m, c: f"input_conv_{m[1]}"),
        (r"(up|down)_(\d+)/(deconv(?:_[01])?|conv(?:_[01])?|input)",
         lambda m, c: f"{m[1]}_units.{m[2]}.{m[3]}"),
        (r"reconstruction", lambda m, c: "reconstruction")],
    "ipt": [
        (r"head_(\d+)_conv", lambda m, c: f"head.{m[1]}.0"),
        (r"head_(\d+)_res(\d)/conv_(\d+)",
         lambda m, c: f"head.{m[1]}.{int(m[2]) + 1}.body.{2 * int(m[3])}"),
        (r"tail_(\d+)_up/conv_(\d+)",
         lambda m, c: f"tail.{m[1]}.0.{2 * int(m[2])}"),
        (r"tail_(\d+)_conv", lambda m, c: f"tail.{m[1]}.1"),
        (r"body/linear_encoding", lambda m, c: "body.linear_encoding"),
        (r"body/mlp_head_([01])",
         lambda m, c: f"body.mlp_head.{3 * int(m[1])}"),
        (r"body/query_embed", lambda m, c: "body.query_embed.weight"),
        (r"body/position_encoding",
         lambda m, c: "body.position_encoding.pe.weight"),
        (_ENC + r"/(self_attn|multihead_attn)/[qkv]_proj",
         lambda m, c: f"body.{m[1]}.layers.{m[2]}.{m[3]}.in_proj_weight"),
        (_ENC + r"/(self_attn|multihead_attn)/out_proj",
         lambda m, c: f"body.{m[1]}.layers.{m[2]}.{m[3]}.out_proj"),
        (_ENC + r"/(linear[12]|norm[123])",
         lambda m, c: f"body.{m[1]}.layers.{m[2]}.{m[3]}")],
}
_RULES["srresnet"] = _RULES["edsr"]


def _torch_shape(path: Tuple[str, ...], shape: Tuple[int, ...]):
    """A flax leaf's shape in the reference layout."""
    if path[-1] != "kernel":
        return shape
    if len(shape) == 5:  # Conv3d DHWIO -> OIDHW
        return (shape[4], shape[3], shape[0], shape[1], shape[2])
    if len(shape) == 4 and path[-2] == "deconv":  # (kh, kw, in, out)
        return (shape[2], shape[3], shape[0], shape[1])
    if len(shape) == 4:  # HWIO -> OIHW
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(reversed(shape))  # Linear (in, out) -> (out, in)


def reference_template(model: torch.nn.Module,
                       arch: str) -> Dict[str, Tuple[int, ...]]:
    """{reference key: shape} of the reference network that a built port
    model of ``arch`` (a ``torch_import._MAPPERS`` key) stands for: what
    ``export_from_template`` fills and ``convert_state_dict`` reads back.
    RDST and SwinIR: the port's own state_dict (their reference layout).
    The families with MeanShift convs get ``sub_mean`` / ``add_mean``
    entries; PReLU slopes and window buffers, which no mapper reads, are
    left out."""
    from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict

    if arch in ("rdst", "swinir"):
        return {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if arch not in _RULES:
        raise KeyError(f"no reference layout for {arch!r}")
    flat = _flatten(import_state_dict(model.state_dict())["params"])
    mods = {"/".join(p[:-1]) for p in flat}
    tops = {p[0] for p in flat}
    ctx = {"tail_up": "tail_up" in tops,
           "body": sum(bool(re.fullmatch(r"body_\d+", t)) for t in tops),
           "rcab": {}}
    for m in mods:
        r = re.match(r"body_(\d+)/rcab_(\d+)", m)
        if r:
            ctx["rcab"][r[1]] = max(ctx["rcab"].get(r[1], 0), int(r[2]) + 1)
    out: Dict[str, Tuple[int, ...]] = {}
    for path, v in sorted(flat.items()):
        leaf = path[-1]
        mod = path[:-1] if leaf in ("kernel", "bias", "scale") else path
        if len(mod) > 1 and mod[-1] in ("conv", "deconv") and leaf in (
                "kernel", "bias"):
            mod = mod[:-1]  # the package's Conv / ConvTranspose wrapper
        name = "/".join(mod)
        for pattern, fmt in _RULES[arch]:
            m = re.fullmatch(pattern, name)
            if m:
                break
        else:
            raise KeyError(f"{arch}: no reference key for {'/'.join(path)}")
        key = fmt(m, ctx)
        if mod != path:
            key += "" if key.endswith("in_proj_weight") else (
                ".bias" if leaf == "bias" else ".weight")
        shape = _torch_shape(path, tuple(v.shape))
        if key.endswith("in_proj_weight"):  # q, k, v stacked on rows
            shape = (out.get(key, (0,))[0] + shape[0], shape[1])
        out[key] = shape
    if arch in _MEAN_SHIFT:
        n = len(getattr(model, "mean", (0.0,)))
        out.update({k: v.shape for k, v in mean_shift_entries(
            (0.0,) * n, (1.0,) * n).items()})
    return out


def mean_std(model: torch.nn.Module) -> Tuple[Sequence[float],
                                              Sequence[float]]:
    """A port model's normalization (its MeanShift's), (0,), (1,) if none."""
    return getattr(model, "mean", (0.0,)), getattr(model, "std", (1.0,))
