"""Weight carry-over: a JAX ``RDSTSR`` (RDST-N and ESTSR too) or ``SwinIR``
parameter tree -> the port's state_dict; and both ways for the networks
whose port modules carry the flax module names (the discriminators, the
seg UNet, InceptionV3, the PatchGAN): :func:`export_flax_tree` /
:func:`import_flax_tree`; and for EDSR, MetaSR, WaveletSR, Swin-MLP and the
convolutional families (``NAMED_GENERATORS``), named as flax names them
but with each flax ``Conv``'s inner ``conv`` level dropped and a Swin
stack's ``blocks_i`` as ``blocks.i``: :func:`export_named` /
:func:`import_named`.

The port's modules are named so that their ``state_dict`` keys are the
reference RDSTSR and SwinIR keys that ``rdst_tpu/checkpoint/
torch_export.py::export_rdstsr`` and ``::export_swinir`` emit. This module
repeats those mappings on numpy trees (as ``checkpoint.msgpack_reader``
returns them), without flax:

* conv kernels HWIO -> OIHW;
* dense kernels (in, out) -> (out, in);
* LayerNorm ``scale`` -> ``weight``;
* the MeanShift 1x1 convs rebuilt from the (mean, std) normalization.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np

from rdst_tpu_torch.checkpoint.msgpack_reader import flatten


def _conv_w(v):  # HWIO -> OIHW
    return np.ascontiguousarray(np.asarray(v).transpose(3, 2, 0, 1))


def _linear_w(v):  # (in, out) -> (out, in)
    return np.ascontiguousarray(np.asarray(v).T)


def mean_shift_entries(mean: Sequence[float],
                       std: Sequence[float]) -> Dict[str, np.ndarray]:
    """``sub_mean``/``add_mean`` 1x1-conv weights for (mean, std)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    nc = len(mean)
    eye = np.eye(nc, dtype=np.float32).reshape(nc, nc, 1, 1)
    return {
        "sub_mean.weight": eye / std.reshape(nc, 1, 1, 1),
        "sub_mean.bias": -mean / std,
        "add_mean.weight": eye * std.reshape(nc, 1, 1, 1),
        "add_mean.bias": mean.copy(),
    }


_SWIN_LEAVES = (
    ("/attn/qkv/kernel", ".attn.qkv.weight"),
    ("/attn/qkv/bias", ".attn.qkv.bias"),
    ("/attn/proj/kernel", ".attn.proj.weight"),
    ("/attn/proj/bias", ".attn.proj.bias"),
    ("/attn/relative_position_bias_table",
     ".attn.relative_position_bias_table"),
    ("/mlp/fc1/kernel", ".mlp.fc1.weight"),
    ("/mlp/fc1/bias", ".mlp.fc1.bias"),
    ("/mlp/fc2/kernel", ".mlp.fc2.weight"),
    ("/mlp/fc2/bias", ".mlp.fc2.bias"),
    ("/norm1/scale", ".norm1.weight"),
    ("/norm1/bias", ".norm1.bias"),
    ("/norm2/scale", ".norm2.weight"),
    ("/norm2/bias", ".norm2.bias"),
)


def _swin_leaf(path: str, value):
    """Translate the inner Swin-block part of a flax path."""
    p = re.sub(r"blocks_(\d+)", r"blocks.\1", path)
    for src, dst in _SWIN_LEAVES:
        p = p.replace(src, dst)
    p = p.replace("/", ".")
    if p.endswith(".weight") and np.asarray(value).ndim == 2:
        value = _linear_w(value)
    return p, np.asarray(value)


def _conv_leaf(leaf: str, v):
    name = "weight" if leaf == "kernel" else "bias"
    return name, (_conv_w(v) if v.ndim == 4 else v)


def export_rdstsr(params: dict, mean=(0.0,),
                  std=(1.0,)) -> Dict[str, np.ndarray]:
    """JAX RDSTSR, RDSTSR_N or ESTSR params (nested numpy dict, with or
    without the top ``params`` level) -> the port's state_dict (numpy
    values)."""
    flat = flatten(params["params"] if "params" in params else params)
    sd: Dict[str, np.ndarray] = dict(mean_shift_entries(mean, std))
    for path, v in flat.items():
        p = "/".join(path)
        v = np.asarray(v)
        if p.startswith("head/conv/"):
            name, val = _conv_leaf(path[-1], v)
            sd[f"head.{name}"] = val
        elif p.startswith("patch_embed_norm/"):
            leaf = "weight" if p.endswith("scale") else "bias"
            sd[f"patch_embed.norm.{leaf}"] = v
        elif p == "absolute_pos_embed":
            sd["absolute_pos_embed"] = v
        elif p.startswith("norm/"):
            leaf = "weight" if p.endswith("scale") else "bias"
            sd[f"norm.{leaf}"] = v
        elif p.startswith("conv_after_body"):
            m = re.match(r"conv_after_body(?:_(\d+))?/conv/(kernel|bias)", p)
            idx = f".{m.group(1)}" if m.group(1) else ""
            name, val = _conv_leaf(m.group(2), v)
            sd[f"conv_after_body{idx}.{name}"] = val
        elif p.startswith("tail_up/"):
            m = re.match(r"tail_up/conv_(\d+)/conv/(kernel|bias)", p)
            name, val = _conv_leaf(m.group(2), v)
            sd[f"tail.0.{2 * int(m.group(1))}.{name}"] = val
        elif p.startswith("tail_conv/"):
            name, val = _conv_leaf(path[-1], v)
            sd[f"tail.1.{name}"] = val
        elif p.startswith(("tail_meta/", "bottleneck_")):
            # the scale-free MetaUpSampler; RDST-N's global bottleneck
            # (Dense or Conv layers)
            sd.update(_named_leaf(path, v))
        elif p.startswith("body_"):
            # body_{i}/body_{j}/(head|tail)_{k} adapters,
            # body_{i}/body_{j}/body/blocks_{k}/... Swin blocks,
            # body_{i}/conv(_k)/conv bottleneck; ESTSR nests one level
            # more (body_{i}/body_{j} an RDSTB, body_{i}/conv its own)
            q = re.sub(r"^body_(\d+)", r"body.\1", p)
            q = re.sub(r"/body_(\d+)", r"/body.\1", q)
            m = re.search(r"/(head|tail)_(\d+)/(kernel|bias|scale)$", q)
            if m:
                base = q[: m.start()].replace("/", ".")
                leaf = "weight" if m.group(3) in ("kernel", "scale") else "bias"
                val = (_linear_w(v) if (m.group(3) == "kernel" and v.ndim == 2)
                       else v)
                sd[f"{base}.{m.group(1)}.{m.group(2)}.{leaf}"] = val
                continue
            m = re.search(r"/conv(?:_(\d+))?/conv/(kernel|bias)$", q)
            if m:
                base = q[: m.start()].replace("/", ".")
                idx = f".{m.group(1)}" if m.group(1) else ""
                name, val = _conv_leaf(m.group(2), v)
                sd[f"{base}.conv{idx}.{name}"] = val
                continue
            head, _, rest = q.partition("/body/")
            key, val = _swin_leaf("/" + rest, v)
            sd[head.replace("/", ".") + ".body" + key] = val
        else:
            raise KeyError(f"unmapped parameter path: {p}")
    return sd


def export_swinir(params: dict) -> Dict[str, np.ndarray]:
    """JAX SwinIR params (nested numpy dict, with or without the top
    ``params`` level) -> the port's SwinIR state_dict (numpy values),
    as ``torch_export.export_swinir`` maps them. SwinIR has no MeanShift
    convs: its mean is not a parameter."""
    flat = flatten(params["params"] if "params" in params else params)
    sd: Dict[str, np.ndarray] = {}
    for path, v in flat.items():
        p = "/".join(path)
        v = np.asarray(v)
        m = re.match(r"^(conv_first|conv_after_body|conv_last|conv_hr|"
                     r"conv_up1|conv_up2)/conv/(kernel|bias)$", p)
        if m:
            name, val = _conv_leaf(m.group(2), v)
            sd[f"{m.group(1)}.{name}"] = val
            continue
        m = re.match(r"^conv_before_upsample/conv/(kernel|bias)$", p)
        if m:
            name, val = _conv_leaf(m.group(1), v)
            sd[f"conv_before_upsample.0.{name}"] = val
            continue
        if p.startswith("patch_embed_norm/"):
            leaf = "weight" if p.endswith("scale") else "bias"
            sd[f"patch_embed.norm.{leaf}"] = v
            continue
        if p == "absolute_pos_embed":
            sd[p] = v
            continue
        if p.startswith("norm/"):
            leaf = "weight" if p.endswith("scale") else "bias"
            sd[f"norm.{leaf}"] = v
            continue
        m = re.match(r"^upsample_conv/conv/(kernel|bias)$", p)
        if m:  # pixelshuffledirect: one conv + shuffle
            name, val = _conv_leaf(m.group(1), v)
            sd[f"upsample.0.{name}"] = val
            continue
        m = re.match(r"^upsample_(\d+)/conv/(kernel|bias)$", p)
        if m:  # pixelshuffle: convs at the even indices
            name, val = _conv_leaf(m.group(2), v)
            sd[f"upsample.{2 * int(m.group(1))}.{name}"] = val
            continue
        m = re.match(r"^layers_(\d+)/conv(?:_(\d+))?/conv/(kernel|bias)$", p)
        if m:
            idx = f".{m.group(2)}" if m.group(2) else ""
            name, val = _conv_leaf(m.group(3), v)
            sd[f"layers.{m.group(1)}.conv{idx}.{name}"] = val
            continue
        m = re.match(r"^layers_(\d+)/residual_group/(.+)$", p)
        if m:
            key, val = _swin_leaf("/" + m.group(2), v)
            sd[f"layers.{m.group(1)}.residual_group" + key] = val
            continue
        raise KeyError(f"unmapped SwinIR parameter path: {p}")
    return sd


# an UpSampler's flax name: tail_up, MDSR's tail_up_4, IPT's tail_0_up
_UPSAMPLER = re.compile(r"tail(_\d+)?_up(_\d+)?")
# flax convs that are not wrapped in the package's ``Conv`` (no inner
# ``conv`` level): ConvNeXt's depthwise conv, DBPN's transposed conv
_DIRECT_CONVS = ("dwconv", "deconv")


def _deconv_w(v):
    """flax ConvTranspose kernel (kh, kw, in, out), applied unflipped ->
    torch ConvTranspose2d weight (in, out, kh, kw), applied as the
    correlation with the flipped kernel: both spatial axes flipped."""
    return np.ascontiguousarray(v[::-1, ::-1].transpose(2, 3, 0, 1))


def _named_leaf(path, v) -> Dict[str, np.ndarray]:
    """One flax leaf of a network named as flax names it (EDSR, MetaSR, a
    MetaUpSampler, WaveletSR, Swin-MLP, RDST-N's bottleneck, the
    convolutional families) as the port's entry: a ``Conv``'s ``conv``
    level dropped (HWIO -> OIHW), an ``UpSampler``'s ``conv_i`` at index
    2i of its Sequential, a flax ``Sequential``-like ``name_i`` of a Swin
    stack (``blocks_i``) or of a bottleneck as ``name.i``, dense kernels
    (in, out) -> (out, in), a ``ConvTranspose`` kernel flipped
    (:func:`_deconv_w`), a 3-D conv kernel DHWIO -> OIDHW, LayerNorm
    ``scale`` -> ``weight``; any other leaf (``gamma``, IPT's tables) as it
    is."""
    v = np.asarray(v)
    mods, leaf = [], path[-1]
    for m in path[:-1]:
        mods += (re.sub(r"^(blocks|bottleneck)_(\d+)$", r"\1.\2", m)
                 .split("."))
    if mods and mods[-1] == "conv":
        mods = mods[:-1]
    if len(mods) >= 2 and _UPSAMPLER.fullmatch(mods[-2]):
        mods[-1] = str(2 * int(mods[-1].split("_")[1]))
    if leaf == "kernel":
        if v.ndim == 5:
            v = np.ascontiguousarray(v.transpose(4, 3, 0, 1, 2))
        elif v.ndim == 4:
            v = _deconv_w(v) if mods[-1] == "deconv" else _conv_w(v)
        else:
            v = _linear_w(v)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return {".".join(mods + [leaf]): v}


def export_named(params: dict) -> Dict[str, np.ndarray]:
    """JAX params of a generator named as flax names it (every one of
    ``NAMED_GENERATORS``; with or without the top ``params`` level) -> the
    port's state_dict (numpy values). None has MeanShift parameters: the
    mean shift is a function in both packages, or absent."""
    flat = flatten(params["params"] if "params" in params else params)
    sd: Dict[str, np.ndarray] = {}
    for path, v in flat.items():
        sd.update(_named_leaf(path, v))
    return sd


def import_named(state_dict) -> dict:
    """The inverse of :func:`export_named` (and of :func:`_named_leaf`):
    the port's state_dict (tensors or arrays) -> ``{"params": ...}``
    numpy trees in the flax layout."""
    params: dict = {}
    convs = {k.rsplit(".", 1)[0] for k, v in state_dict.items()
             if k.endswith(".weight") and len(v.shape) == 4
             and k.split(".")[-2] not in _DIRECT_CONVS}
    for key, val in state_dict.items():
        v = np.asarray(val.detach().cpu().float().numpy()
                       if hasattr(val, "detach") else val, np.float32)
        *mods, leaf = re.sub(r"(^|\.)(blocks|bottleneck)\.(\d+)(?=\.)",
                             r"\1\2_\3", key).split(".")
        conv = key.rsplit(".", 1)[0] in convs
        if len(mods) >= 2 and _UPSAMPLER.fullmatch(mods[-2]):
            mods[-1] = f"conv_{int(mods[-1]) // 2}"
        if conv:  # a flax Conv holds its kernel and bias under 'conv'
            mods.append("conv")
        if leaf == "weight" and v.ndim == 1:  # a LayerNorm
            leaf = "scale"
        elif leaf == "weight":
            leaf = "kernel"
            if v.ndim == 5:
                v = v.transpose(2, 3, 4, 1, 0)
            elif v.ndim == 4 and mods[-1] == "deconv":
                v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
            v = np.ascontiguousarray(v)
        tree = params
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = v
    return {"params": params}


NAMED_GENERATORS = ("edsr", "metasr", "wtb", "wtr", "wtp", "wts", "swinmlp",
                    "swin-mlp", "srresnet", "srdensenet", "rdn", "esrgan",
                    "mdsr", "rcan", "han", "convnet-large", "convnet-lite",
                    "dbpn", "zssr", "ipt")


def export_params(params: dict, generator: str, mean=(0.0,),
                  std=(1.0,)) -> Dict[str, np.ndarray]:
    """The port's state_dict of a JAX parameter tree of ``generator``
    ('rdst' -- RDST-N too --, 'estsr', 'swinir'/'swin', or one of
    ``NAMED_GENERATORS``)."""
    name = str(generator).strip().lower()
    if name in ("rdst", "estsr"):
        return export_rdstsr(params, mean, std)
    if name in ("swinir", "swin"):
        return export_swinir(params)
    if name in NAMED_GENERATORS:
        return export_named(params)
    raise ValueError(f"unknown generator {generator!r}")


# -- networks named as their flax modules --------------------------------------

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _torch_path(path) -> str:
    """A flax module path as a state-dict prefix: a Swin stack's
    ``blocks_i`` under ``residual_group`` is the port's ``blocks.i``."""
    p = "/".join(path)
    p = re.sub(r"residual_group/blocks_(\d+)", r"residual_group/blocks.\1", p)
    return p.replace("/", ".")


def export_flax_tree(variables: dict) -> Dict[str, np.ndarray]:
    """JAX variables ``{'params', 'batch_stats'}`` (numpy) of a network
    whose port modules carry the flax names (``models.seg_unet``,
    ``metrics.inception``, ``losses.patchgan.PatchGAN``, the
    discriminators through :func:`export_discriminator`) -> the port's
    state_dict:
    conv kernels HWIO -> OIHW ``weight``, dense kernels (in, out) ->
    (out, in), ``scale`` -> ``weight``, BN ``mean``/``var`` ->
    ``running_mean``/``running_var``."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in flatten(variables.get("params", {})).items():
        v, leaf = np.asarray(v), path[-1]
        key = _torch_path(path[:-1])
        if leaf == "kernel":
            sd[f"{key}.weight"] = _conv_w(v) if v.ndim == 4 else _linear_w(v)
        elif leaf == "scale":
            sd[f"{key}.weight"] = v
        else:
            sd[f"{key}.{leaf}"] = v
    for path, v in flatten(variables.get("batch_stats", {})).items():
        sd[f"{_torch_path(path[:-1])}.{_BN_STATS[path[-1]]}"] = np.asarray(v)
    return sd


def import_flax_tree(state_dict) -> dict:
    """The inverse of :func:`export_flax_tree`: a state_dict (tensors or
    arrays) -> ``{'params': ..., 'batch_stats': ...}`` numpy trees (the
    ``batch_stats`` entry only when there are running statistics)."""
    out: dict = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _BN_STATS.items()}
    for key, v in state_dict.items():
        v = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                       else v, dtype=np.float32)
        parts = key.split(".")
        mod, leaf = re.sub(r"blocks/(\d+)", r"blocks_\1",
                           "/".join(parts[:-1])).split("/"), parts[-1]
        if leaf in stats:
            tree, leaf = out["batch_stats"], stats[leaf]
        else:
            tree = out["params"]
            if leaf == "weight":
                leaf = "scale" if v.ndim == 1 else "kernel"
                if v.ndim == 4:
                    v = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
                elif v.ndim == 2:
                    v = np.ascontiguousarray(v.T)
        for m in mod:
            tree = tree.setdefault(m, {})
        tree[leaf] = v
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def _nhwc_rows_to_nchw(kernel: np.ndarray, chw) -> np.ndarray:
    """A dense kernel on an NHWC flatten, (H*W*C, out), as the rows of an
    NCHW flatten, (C*H*W, out)."""
    c, h, w = chw
    out = kernel.shape[-1]
    return np.ascontiguousarray(kernel.reshape(h, w, c, out)
                                .transpose(2, 0, 1, 3).reshape(-1, out))


def export_discriminator(variables: dict, map_chw=None) -> Dict[str, np.ndarray]:
    """JAX discriminator variables -> the port's state_dict. The CNN
    discriminator flattens its last (C, H, W) map in NCHW order in the
    port, NHWC in the JAX package: pass ``map_chw`` and its first dense
    kernel's rows are reordered to match (the Swin discriminator flattens
    NHWC in both: ``map_chw=None``)."""
    if map_chw is not None:
        variables = dict(variables, params=dict(variables["params"]))
        cls = dict(variables["params"]["classifier_0"])
        cls["kernel"] = _nhwc_rows_to_nchw(np.asarray(cls["kernel"]), map_chw)
        variables["params"]["classifier_0"] = cls
    return export_flax_tree(variables)


def import_discriminator(state_dict, map_chw=None) -> dict:
    """The inverse of :func:`export_discriminator`."""
    tree = import_flax_tree(state_dict)
    if map_chw is not None:
        c, h, w = map_chw
        k = tree["params"]["classifier_0"]["kernel"]
        tree["params"]["classifier_0"]["kernel"] = np.ascontiguousarray(
            k.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(-1,
                                                                 k.shape[-1]))
    return tree
