"""Pure-stdlib writer of flax ``.msgpack`` parameter snapshots: the inverse
of ``checkpoint.msgpack_reader`` and ``checkpoint.convert``.

:func:`import_rdstsr` (RDST, RDST-N, ESTSR) and :func:`import_swinir` (and
``checkpoint.convert.import_named`` for EDSR, MetaSR, WaveletSR, Swin-MLP
and the convolutional families) turn the port's
``state_dict`` back into the JAX package's parameter trees
(conv kernels OIHW -> HWIO, dense kernels (out, in) -> (in, out),
LayerNorm ``weight`` -> ``scale``; the MeanShift convs, which are not
parameters there, are left out), and
:func:`to_bytes` encodes a nested dict of numpy arrays as
``flax.serialization.to_bytes`` does: a msgpack map tree whose leaves are
ext records of type 1 holding ``[shape, dtype name, C-order bytes]``.
The result loads with ``flax.serialization.from_bytes`` into the JAX
model's tree, and with this package's reader, on a machine without flax
or ``msgpack``.
"""

from __future__ import annotations

import re
import struct
from typing import Dict

import numpy as np

from rdst_tpu_torch.checkpoint.convert import _SWIN_LEAVES, import_named
from rdst_tpu_torch.checkpoint.msgpack_reader import NDARRAY_EXT


def _len_header(n: int, fix_base, fix_max, codes) -> bytes:
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for limit, code, fmt in codes:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (0, 2**64 - 1, 0xCF, ">Q"),
                              (-2**7, 2**7 - 1, 0xD0, ">b"),
                              (-2**15, 2**15 - 1, 0xD1, ">h"),
                              (-2**31, 2**31 - 1, 0xD2, ">i"),
                              (-2**63, 2**63 - 1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _len_header(n, None, 0, ((0xFF, 0xC7, ">B"),
                                        (0xFFFF, 0xC8, ">H"),
                                        (0xFFFFFFFF, 0xC9, ">I")))
    return head + struct.pack(">b", code) + data


def packb(obj) -> bytes:
    """msgpack encoding of dicts (str keys), lists/tuples, str, bytes,
    bool, None, int, float and numpy arrays (flax's ndarray ext)."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, (int, np.integer)):
        return _pack_int(int(obj))
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode()
        return _len_header(len(raw), 0xA0, 31, ((0xFF, 0xD9, ">B"),
                                                (0xFFFF, 0xDA, ">H"),
                                                (0xFFFFFFFF, 0xDB, ">I"))) + raw
    if isinstance(obj, bytes):
        return _len_header(len(obj), None, 0, ((0xFF, 0xC4, ">B"),
                                               (0xFFFF, 0xC5, ">H"),
                                               (0xFFFFFFFF, 0xC6, ">I"))) + obj
    if isinstance(obj, (list, tuple)):
        return _len_header(len(obj), 0x90, 15, ((0xFFFF, 0xDC, ">H"),
                                                (0xFFFFFFFF, 0xDD, ">I"))) + \
            b"".join(packb(v) for v in obj)
    if isinstance(obj, dict):
        out = [_len_header(len(obj), 0x80, 15, ((0xFFFF, 0xDE, ">H"),
                                                (0xFFFFFFFF, 0xDF, ">I")))]
        for k, v in obj.items():
            out.append(packb(str(k)))
            out.append(packb(v))
        return b"".join(out)
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.ascontiguousarray(obj)
        return _pack_ext(NDARRAY_EXT, packb(
            (list(arr.shape), arr.dtype.name, arr.tobytes("C"))))
    raise TypeError(f"cannot msgpack {type(obj).__name__}")


def to_bytes(tree: dict) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of numpy arrays."""
    return packb(tree)


def _conv(name: str, v: np.ndarray):
    key = "kernel" if name == "weight" else "bias"
    return key, (np.ascontiguousarray(v.transpose(2, 3, 1, 0))
                 if v.ndim == 4 else v)


def _set(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


_SWIN_INV = [(dst.lstrip("."), src.lstrip("/")) for src, dst in _SWIN_LEAVES]


def import_rdstsr(state_dict: Dict[str, object]) -> dict:
    """The port's RDSTSR, RDSTSR_N or ESTSR ``state_dict`` (tensors or
    arrays) -> the JAX package's variables ``{"params": ...}`` with
    float32 numpy leaves: the inverse of
    ``checkpoint.convert.export_rdstsr``."""
    params: dict = {}
    meta: dict = {}
    for key, val in state_dict.items():
        v = _f32(val)
        if key.startswith(("sub_mean.", "add_mean.")):
            continue  # the normalization, not a parameter in flax
        leaf = key.rsplit(".", 1)[-1]
        if key.startswith("head."):
            _set(params, ("head", "conv", _conv(leaf, v)[0]),
                 _conv(leaf, v)[1])
        elif key.startswith("patch_embed.norm."):
            _set(params, ("patch_embed_norm",
                          "scale" if leaf == "weight" else "bias"), v)
        elif key.startswith("norm."):
            _set(params, ("norm", "scale" if leaf == "weight" else "bias"), v)
        elif key == "absolute_pos_embed":
            params["absolute_pos_embed"] = v
        elif key.startswith("conv_after_body."):
            m = re.match(r"conv_after_body(?:\.(\d+))?\.(weight|bias)$", key)
            name = ("conv_after_body" if m.group(1) is None
                    else f"conv_after_body_{m.group(1)}")
            k, val2 = _conv(m.group(2), v)
            _set(params, (name, "conv", k), val2)
        elif key.startswith("tail.0."):
            m = re.match(r"tail\.0\.(\d+)\.(weight|bias)$", key)
            k, val2 = _conv(m.group(2), v)
            _set(params, ("tail_up", f"conv_{int(m.group(1)) // 2}", "conv",
                          k), val2)
        elif key.startswith("tail.1."):
            k, val2 = _conv(leaf, v)
            _set(params, ("tail_conv", "conv", k), val2)
        elif key.startswith(("tail_meta.", "bottleneck.")):
            # the scale-free MetaUpSampler; RDST-N's global bottleneck
            meta[key] = v
        elif key.startswith("body."):
            _import_body(params, key, v)
        else:
            raise KeyError(f"unmapped state_dict key: {key}")
    if meta:
        params.update(import_named(meta)["params"])
    return {"params": params}


def _import_body(params: dict, key: str, v: np.ndarray) -> None:
    """One ``body.i[.body.j]...`` entry: an RDSTB's (or ESTSR's RRDSTB's)
    conv, a DSTL's adapter or a Swin block's leaf."""
    m = re.match(r"((?:body\.\d+\.)+)(.+)$", key)
    names = tuple(f"body_{i}" for i in re.findall(r"\d+", m.group(1)))
    rest = m.group(2)
    c = re.match(r"conv(?:\.(\d+))?\.(weight|bias)$", rest)
    if c:
        name = "conv" if c.group(1) is None else f"conv_{c.group(1)}"
        k, val = _conv(c.group(2), v)
        _set(params, (*names, name, "conv", k), val)
        return
    a = re.match(r"(head|tail)\.(\d+)\.(weight|bias)$", rest)
    if a:
        side, k, leaf = a.groups()
        if leaf == "weight":
            leaf, v = ("kernel", np.ascontiguousarray(v.T)) if v.ndim == 2 \
                else ("scale", v)
        _set(params, (*names, f"{side}_{k}", leaf), v)
        return
    b = re.match(r"body\.blocks\.(\d+)\.(.+)$", rest)
    if b and _swin_block_leaf(params, (*names, "body", f"blocks_{b.group(1)}"),
                              b.group(2), v):
        return
    raise KeyError(f"unmapped state_dict key: {key}")


def _swin_block_leaf(params: dict, prefix: tuple, rest: str,
                     v: np.ndarray) -> bool:
    """Set a Swin block's leaf ``rest`` (``attn.qkv.weight``, ...) under
    ``prefix``; False when ``rest`` is not one."""
    for dst, src in _SWIN_INV:
        if rest == dst:
            if v.ndim == 2 and src.endswith("kernel"):
                v = np.ascontiguousarray(v.T)
            _set(params, (*prefix, *src.split("/")), v)
            return True
    return False


def _f32(val) -> np.ndarray:
    return np.asarray(val.detach().cpu().float().numpy()
                      if hasattr(val, "detach") else val, np.float32)


def import_swinir(state_dict: Dict[str, object]) -> dict:
    """The port's SwinIR ``state_dict`` -> the JAX package's variables
    ``{"params": ...}``: the inverse of ``checkpoint.convert
    .export_swinir``."""
    params: dict = {}
    for key, val in state_dict.items():
        v = _f32(val)
        leaf = key.rsplit(".", 1)[-1]
        m = re.match(r"^(conv_first|conv_after_body|conv_last|conv_hr|"
                     r"conv_up1|conv_up2)\.(weight|bias)$", key)
        if m:
            k, val2 = _conv(m.group(2), v)
            _set(params, (m.group(1), "conv", k), val2)
            continue
        m = re.match(r"^conv_before_upsample\.0\.(weight|bias)$", key)
        if m:
            k, val2 = _conv(m.group(1), v)
            _set(params, ("conv_before_upsample", "conv", k), val2)
            continue
        if key == "absolute_pos_embed":
            params[key] = v
            continue
        if key.startswith(("patch_embed.norm.", "norm.")):
            name = "patch_embed_norm" if key.startswith("patch") else "norm"
            _set(params, (name, "scale" if leaf == "weight" else "bias"), v)
            continue
        m = re.match(r"^upsample\.(\d+)\.(weight|bias)$", key)
        if m:
            k, val2 = _conv(m.group(2), v)
            name = ("upsample_conv" if "conv_last.weight" not in state_dict
                    else f"upsample_{int(m.group(1)) // 2}")
            _set(params, (name, "conv", k), val2)
            continue
        m = re.match(r"^layers\.(\d+)\.conv(?:\.(\d+))?\.(weight|bias)$",
                     key)
        if m:
            name = "conv" if m.group(2) is None else f"conv_{m.group(2)}"
            k, val2 = _conv(m.group(3), v)
            _set(params, (f"layers_{m.group(1)}", name, "conv", k), val2)
            continue
        m = re.match(r"^layers\.(\d+)\.residual_group\.blocks\.(\d+)\."
                     r"(.+)$", key)
        if m and _swin_block_leaf(
                params, (f"layers_{m.group(1)}", "residual_group",
                         f"blocks_{m.group(2)}"), m.group(3), v):
            continue
        raise KeyError(f"unmapped SwinIR state_dict key: {key}")
    return {"params": params}


def import_state_dict(state_dict) -> dict:
    """The JAX variables of a generator's ``state_dict``: RDSTSR /
    RDSTSR_N / ESTSR by their MeanShift ``sub_mean``, SwinIR by its
    ``layers.*`` residual groups, every other generator (EDSR, MetaSR,
    WaveletSR, Swin-MLP, the convolutional families) by its flax
    names."""
    if "sub_mean.weight" in state_dict:
        return import_rdstsr(state_dict)
    if any(k.startswith("layers.") for k in state_dict):
        return import_swinir(state_dict)
    return import_named(state_dict)


def write_snapshot(path: str, state_dict) -> None:
    """Write a generator's weights (any the port builds) as a flax
    ``.msgpack`` snapshot."""
    data = to_bytes(import_state_dict(state_dict))
    with open(path, "wb") as f:
        f.write(data)
