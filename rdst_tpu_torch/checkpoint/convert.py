"""Weight carry-over: a JAX ``RDSTSR`` or ``SwinIR`` parameter tree -> the
port's state_dict.

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
    """JAX RDSTSR params (nested numpy dict, with or without the top
    ``params`` level) -> the port's RDSTSR state_dict (numpy values)."""
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
        elif p.startswith("body_"):
            # body_{i}/body_{j}/(head|tail)_{k} adapters,
            # body_{i}/body_{j}/body/blocks_{k}/... Swin blocks,
            # body_{i}/conv(_k)/conv bottleneck
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
        m = re.match(r"^(conv_first|conv_after_body|conv_last)/conv/"
                     r"(kernel|bias)$", p)
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


def export_params(params: dict, generator: str, mean=(0.0,),
                  std=(1.0,)) -> Dict[str, np.ndarray]:
    """The port's state_dict of a JAX parameter tree of ``generator``
    ('rdst', or 'swinir'/'swin')."""
    name = str(generator).strip().lower()
    if name == "rdst":
        return export_rdstsr(params, mean, std)
    if name in ("swinir", "swin"):
        return export_swinir(params)
    raise NotImplementedError(
        f"carrying {generator!r} snapshots over comes with the model-zoo "
        "slice of the port")
