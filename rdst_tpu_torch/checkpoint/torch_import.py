"""Reference torch state_dict -> flax-layout parameter tree (the port's
copy of ``rdst_tpu/checkpoint/torch_import.py``, numpy and ``re`` only).

Translates checkpoints saved by the reference networks (RDSTSR from
swinIR_variations.py:890-1141, SwinIR from swin_transformer_sr.py:605-868,
and the convolutional families of networks/*.py named in each mapper's
docstring) into the flax parameter tree the JAX package builds; the port
then carries that tree into its modules with ``checkpoint.convert``
(``export_params``), as it carries a ``.msgpack`` snapshot. The mappers
are the JAX package's, key for key: their regexes and docstrings are the
account of the reference layout.

Layout transforms:
* Conv2d  OIHW -> HWIO  (transpose 2,3,1,0)
* Linear  (out,in) -> (in,out)
* LayerNorm weight -> 'scale'
* MeanShift convs and relative_position_index buffers are skipped
  (both are closed-form recomputed at trace time).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np

Path = Tuple[str, ...]


def _conv_w(v):
    return np.ascontiguousarray(np.asarray(v).transpose(2, 3, 1, 0))


def _linear_w(v):
    return np.ascontiguousarray(np.asarray(v).T)


def _leaf(kind: str, which: str):
    """(flax leaf name, transform) for a torch (layer kind, weight|bias)."""
    if which == "bias":
        return "bias", np.asarray
    if kind == "conv":
        return "kernel", _conv_w
    if kind == "linear":
        return "kernel", _linear_w
    if kind == "norm":
        return "scale", np.asarray
    raise ValueError(kind)


def _map_swin_block(rest: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """Map one SwinTransformerBlock's keys (norm1/attn/norm2/mlp)."""
    m = re.match(r"(norm1|norm2)\.(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("norm", m.group(2))
        yield (m.group(1), leaf), tf(value)
        return
    m = re.match(r"attn\.relative_position_bias_table$", rest)
    if m:
        yield ("attn", "relative_position_bias_table"), np.asarray(value)
        return
    if re.match(r"attn\.relative_position_index$", rest) or rest == "attn_mask":
        return  # recomputed buffers
    m = re.match(r"attn\.(qkv|proj)\.(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("linear", m.group(2))
        yield ("attn", m.group(1), leaf), tf(value)
        return
    m = re.match(r"mlp\.(fc1|fc2)\.(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("linear", m.group(2))
        yield ("mlp", m.group(1), leaf), tf(value)
        return
    raise KeyError(f"unmapped swin block key: {rest}")


def _map_basic_layer(rest: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    m = re.match(r"blocks\.(\d+)\.(.+)$", rest)
    if not m:
        raise KeyError(f"unmapped basic layer key: {rest}")
    for path, v in _map_swin_block(m.group(2), value):
        yield (f"blocks_{m.group(1)}",) + path, v


def _map_conv_block(rest: str, value, flax_name: str = "conv"):
    """'weight'/'bias' (1conv) or '{k}.weight' (3conv Sequential)."""
    m = re.match(r"(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("conv", m.group(1))
        yield (flax_name, "conv", leaf), tf(value)
        return
    m = re.match(r"(\d+)\.(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("conv", m.group(2))
        yield (f"{flax_name}_{m.group(1)}", "conv", leaf), tf(value)
        return
    raise KeyError(f"unmapped conv key: {rest}")


def _map_dstl(rest: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """DenseSTLayer: head/tail adapters + BasicLayer body."""
    m = re.match(r"(head|tail)\.(\d+)\.(weight|bias)$", rest)
    if m:
        kind = "norm" if np.asarray(value).ndim == 1 and m.group(3) == "weight" else None
        # disambiguate by shape: LayerNorm weight is 1-D, Linear weight 2-D
        v = np.asarray(value)
        if m.group(3) == "weight":
            kind = "norm" if v.ndim == 1 else "linear"
        else:
            # bias: belongs to whichever module sits at this index; both map to 'bias'
            kind = "linear" if v.ndim == 1 else "norm"
        leaf, tf = _leaf(kind if m.group(3) == "weight" else "linear", m.group(3))
        yield (f"{m.group(1)}_{m.group(2)}", leaf), tf(value)
        return
    m = re.match(r"body\.(.+)$", rest)
    if m:
        for path, v in _map_basic_layer(m.group(1), value):
            yield ("body",) + path, v
        return
    raise KeyError(f"unmapped DSTL key: {rest}")


def _map_rdstb(rest: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    m = re.match(r"body\.(\d+)\.(.+)$", rest)
    if m:
        for path, v in _map_dstl(m.group(2), value):
            yield (f"body_{m.group(1)}",) + path, v
        return
    m = re.match(r"conv\.(.+)$", rest)
    if m:
        yield from _map_conv_block(m.group(1), value)
        return
    if re.match(r"patch_(un)?embed\.", rest):
        return  # no params inside RDSTB embeds
    raise KeyError(f"unmapped RDSTB key: {rest}")


def map_rdstsr_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:  # noqa: C901
    """Translate one RDSTSR torch key to flax (path, value) pairs."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("conv", m.group(1))
        yield ("head", "conv", leaf), tf(value)
        return
    m = re.match(r"^patch_embed\.norm\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("norm", m.group(1))
        yield ("patch_embed_norm", leaf), tf(value)
        return
    if re.match(r"^patch_unembed\.", key):
        return
    if key == "absolute_pos_embed":
        yield ("absolute_pos_embed",), np.asarray(value)
        return
    m = re.match(r"^body\.(\d+)\.(.+)$", key)
    if m:
        for path, v in _map_rdstb(m.group(2), value):
            yield (f"body_{m.group(1)}",) + path, v
        return
    m = re.match(r"^norm\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("norm", m.group(1))
        yield ("norm", leaf), tf(value)
        return
    m = re.match(r"^conv_after_body\.(.+)$", key)
    if m:
        yield from _map_conv_block(m.group(1), value, "conv_after_body")
        return
    m = re.match(r"^tail\.0\.(\d+)\.(weight|bias)$", key)
    if m:  # UpSampler Sequential: torch idx 0,2,... are convs (odd = shuffles)
        leaf, tf = _leaf("conv", m.group(2))
        yield ("tail_up", f"conv_{int(m.group(1)) // 2}", "conv", leaf), tf(value)
        return
    m = re.match(r"^tail\.1\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("conv", m.group(1))
        yield ("tail_conv", "conv", leaf), tf(value)
        return
    m = re.match(r"^tail\.(weight|bias)$", key)
    if m:  # sr_scale == 1: tail is a bare conv
        leaf, tf = _leaf("conv", m.group(1))
        yield ("tail_conv", "conv", leaf), tf(value)
        return
    raise KeyError(f"unmapped RDSTSR key: {key}")


def map_swinir_key(key: str, value, upsampler: str = "pixelshuffledirect") -> Iterable[Tuple[Path, np.ndarray]]:
    if key == "mean":
        return
    m = re.match(r"^(conv_first|conv_after_body|conv_last|conv_hr|conv_up1|conv_up2)\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("conv", m.group(2))
        yield (m.group(1), "conv", leaf), tf(value)
        return
    m = re.match(r"^conv_before_upsample\.0\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("conv", m.group(1))
        yield ("conv_before_upsample", "conv", leaf), tf(value)
        return
    m = re.match(r"^patch_embed\.norm\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("norm", m.group(1))
        yield ("patch_embed_norm", leaf), tf(value)
        return
    if key == "absolute_pos_embed":
        yield ("absolute_pos_embed",), np.asarray(value)
        return
    m = re.match(r"^norm\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("norm", m.group(1))
        yield ("norm", leaf), tf(value)
        return
    m = re.match(r"^layers\.(\d+)\.residual_group\.(.+)$", key)
    if m:
        for path, v in _map_basic_layer(m.group(2), value):
            yield (f"layers_{m.group(1)}", "residual_group") + path, v
        return
    m = re.match(r"^layers\.(\d+)\.conv\.(.+)$", key)
    if m:
        for path, v in _map_conv_block(m.group(2), value):
            yield (f"layers_{m.group(1)}",) + path, v
        return
    if re.match(r"^layers\.\d+\.patch_(un)?embed\.", key):
        return
    m = re.match(r"^upsample\.(\d+)\.(weight|bias)$", key)
    if m:
        leaf, tf = _leaf("conv", m.group(2))
        if upsampler == "pixelshuffledirect":  # UpsampleOneStep: idx 0 only
            yield ("upsample_conv", "conv", leaf), tf(value)
        else:  # classical Upsample chain: even indices are convs
            yield (f"upsample_{int(m.group(1)) // 2}", "conv", leaf), tf(value)
        return
    raise KeyError(f"unmapped SwinIR key: {key}")


def _conv_t_w(v):
    """torch ConvTranspose2d (in, out, kh, kw) -> flax ConvTranspose
    (kh, kw, in, out). torch computes the gradient-of-conv (implicitly
    spatially flipped); flax's default transpose_kernel=False does not
    flip, so flip here."""
    return np.ascontiguousarray(
        np.asarray(v).transpose(2, 3, 0, 1)[::-1, ::-1])


def _conv3d_w(v):
    """torch Conv3d (O, I, D, H, W) -> flax (D, H, W, I, O)."""
    return np.ascontiguousarray(np.asarray(v).transpose(2, 3, 4, 1, 0))


def _yield_conv(path: Path, which: str, value):
    leaf, tf = _leaf("conv", which)
    yield path + ("conv", leaf), tf(value)


def _map_tail(rest: str, value, up="tail_up", conv="tail_conv"):
    """common.py tail Sequential: [UpSampler, conv] or [conv] (scale 1)."""
    m = re.match(r"0\.(\d+)\.(weight|bias)$", rest)
    if m:  # UpSampler: even indices are convs, odd are PixelShuffles
        yield from _yield_conv((up, f"conv_{int(m.group(1)) // 2}"),
                               m.group(2), value)
        return
    m = re.match(r"(?:1\.)?(weight|bias)$", rest)
    if m:
        yield from _yield_conv((conv,), m.group(1), value)
        return
    raise KeyError(f"unmapped tail key: {rest}")


def _map_resblock_body(rest: str, value):
    """common.py ResBlock body Sequential [conv, act, conv] -> conv_{0,1}.

    PReLU slopes (1-D 'weight' at the act slot) are skipped — the flax
    side approximates PReLU with the fixed 0.25 torch-init slope.
    BatchNorm resblock checkpoints are rejected with a clear error (the
    flax SR models are BN-free)."""
    m = re.match(
        r"body\.(\d+)\.(weight|bias|running_mean|running_var"
        r"|num_batches_tracked)$", rest)
    if not m:
        raise KeyError(f"unmapped ResBlock key: {rest}")
    leaf = m.group(2)
    if leaf in ("running_mean", "running_var", "num_batches_tracked"):
        raise KeyError(
            "BatchNorm ResBlock checkpoints are not supported (the flax SR "
            f"models are BN-free): body key {rest!r}")
    if leaf == "weight" and np.asarray(value).ndim == 1:
        return  # PReLU slope
    yield from _yield_conv((f"conv_{int(m.group(1)) // 2}",), leaf, value)


def _map_rdb(rest: str, value):
    """common.py ResidualDenseBlock: DenseLayers + bottle_neck."""
    m = re.match(r"body\.(\d+)\.body\.0\.(weight|bias)$", rest)
    if m:  # DenseLayer's Conv is itself named 'conv' (nn/common.py:127-140)
        yield from _yield_conv((f"dense_{m.group(1)}", "conv"), m.group(2), value)
        return
    m = re.match(r"bottle_neck\.(weight|bias)$", rest)
    if m:
        yield from _yield_conv(("bottleneck",), m.group(1), value)
        return
    raise KeyError(f"unmapped RDB key: {rest}")


def _map_calayer(rest: str, value):
    """rcan/han CALayer: conv_du Sequential [conv, relu, conv, sigmoid]."""
    m = re.match(r"conv_du\.([02])\.(weight|bias)$", rest)
    if not m:
        raise KeyError(f"unmapped CALayer key: {rest}")
    yield from _yield_conv((f"du_{int(m.group(1)) // 2}",), m.group(2), value)


def map_edsr_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """EDSR / SRResNet (the reference's networks/{edsr,srresnet}.py):
    head -> ResBlocks + conv -> tail. Torch PReLU slopes (srresnet) are
    skipped — the flax side uses the fixed 0.25 init value."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    m = re.match(r"^body\.(\d+)\.(body\..+)$", key)
    if m:
        for path, v in _map_resblock_body(m.group(2), value):
            yield (f"body_{m.group(1)}",) + path, v
        return
    m = re.match(r"^body\.\d+\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("body_conv",), m.group(1), value)
        return
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    if key.endswith("activation.weight"):  # PReLU slope
        return
    raise KeyError(f"unmapped EDSR/SRResNet key: {key}")


def map_mdsr_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """MDSR (the reference's networks/mdsr.py): per-scale heads/tails over
    a shared body. ``input_layer`` is dead in the reference forward
    (mdsr.py:86-116 never calls it) and is skipped."""
    if re.match(r"^(sub_mean|add_mean|input_layer)\.", key):
        return
    m = re.match(r"^head_(\d)\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv((f"head_{m.group(1)}",), m.group(2), value)
        return
    m = re.match(r"^body\.(\d+)\.(body\..+)$", key)
    if m:
        for path, v in _map_resblock_body(m.group(2), value):
            yield (f"body_{m.group(1)}",) + path, v
        return
    m = re.match(r"^body\.\d+\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("body_conv",), m.group(1), value)
        return
    m = re.match(r"^tail_(\d)\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(2), value, up=f"tail_up_{m.group(1)}",
                             conv=f"tail_conv_{m.group(1)}")
        return
    raise KeyError(f"unmapped MDSR key: {key}")


def map_rdn_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """RDN (the reference's networks/rdn.py:19-124)."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    m = re.match(r"^F0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("F0",), m.group(1), value)
        return
    m = re.match(r"^body\.(\d+)\.(.+)$", key)
    if m:
        for path, v in _map_rdb(m.group(2), value):
            yield (f"body_{m.group(1)}",) + path, v
        return
    m = re.match(r"^bottleneck\.([01])\.(weight|bias)$", key)
    if m:
        yield from _yield_conv((f"bottleneck_{m.group(1)}",), m.group(2), value)
        return
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    raise KeyError(f"unmapped RDN key: {key}")


def map_srdensenet_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """SRDenseNet (the reference's networks/srdensenet.py:7-115)."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    m = re.match(r"^body\.(\d+)\.body\.(\d+)\.body\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(
            (f"body_{m.group(1)}", f"dense_{m.group(2)}", "conv"),
            m.group(3), value)
        return
    m = re.match(r"^bottleneck\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("bottleneck",), m.group(1), value)
        return
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    raise KeyError(f"unmapped SRDenseNet key: {key}")


def map_esrgan_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """ESRGAN / RRDB generator (the reference's networks/esrgan.py:7-98)."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    m = re.match(r"^body\.(\d+)\.body\.(\d+)\.(.+)$", key)
    if m:  # ResidualRDB -> RDB r inside block b
        for path, v in _map_rdb(m.group(3), value):
            yield (f"body_{m.group(1)}", f"rdb_{m.group(2)}") + path, v
        return
    m = re.match(r"^body\.\d+\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("body_conv",), m.group(1), value)
        return
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    raise KeyError(f"unmapped ESRGAN key: {key}")


def map_zssr_key(key: str, value, num_layers: int = 8) -> Iterable[Tuple[Path, np.ndarray]]:
    """ZSSR (the reference's networks/zssr.py:4-66, norm=None variant):
    model Sequential convs at even indices."""
    m = re.match(r"^model\.(\d+)\.(weight|bias)$", key)
    if not m:
        raise KeyError(f"unmapped ZSSR key: {key}")
    idx = int(m.group(1)) // 2
    if idx == 0:
        name = "head"
    elif idx == num_layers - 1:
        name = "tail"
    else:
        name = f"body_{idx - 1}"
    yield from _yield_conv((name,), m.group(2), value)


def _map_rcab(rest: str, value, ada: bool):
    """RCAB body Sequential [conv|Ada, act, conv|Ada, CALayer]."""
    m = re.match(r"body\.([02])\.(.+)$", rest)
    if m:
        conv_name = f"conv_{int(m.group(1)) // 2}"
        sub = m.group(2)
        if ada:  # Ada_conv: conv0/conv1/conv2 submodules (rcan.py:39-63)
            m2 = re.match(r"(conv[012])\.(weight|bias)$", sub)
            if not m2:
                raise KeyError(f"unmapped Ada_conv key: {sub}")
            yield from _yield_conv((conv_name, m2.group(1)), m2.group(2), value)
            return
        m2 = re.match(r"(weight|bias)$", sub)
        if not m2:
            raise KeyError(f"unmapped RCAB conv key: {sub}")
        yield from _yield_conv((conv_name,), m2.group(1), value)
        return
    m = re.match(r"body\.3\.(.+)$", rest)
    if m:
        for path, v in _map_calayer(m.group(1), value):
            yield ("ca",) + path, v
        return
    raise KeyError(f"unmapped RCAB key: {rest}")


def _map_rg_body(key: str, value, ada: bool):
    """RCAN/HAN shared trunk: body.{g}.body.{j}.<RCAB> | group conv |
    final body conv. Returns a list of (path, value) or None when the
    key is not a trunk key."""
    m = re.match(r"^body\.(\d+)\.body\.(\d+)\.(body\..+)$", key)
    if m:
        return [((f"body_{m.group(1)}", f"rcab_{m.group(2)}") + path, v)
                for path, v in _map_rcab(m.group(3), value, ada)]
    m = re.match(r"^body\.(\d+)\.body\.\d+\.(weight|bias)$", key)
    if m:
        return [((f"body_{m.group(1)}",) + path, v)
                for path, v in _yield_conv(("conv",), m.group(2), value)]
    m = re.match(r"^body\.\d+\.(weight|bias)$", key)
    if m:
        return list(_yield_conv(("body_conv",), m.group(1), value))
    return None


def map_rcan_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """RCAN (the reference's networks/rcan.py:136-190, Ada_conv RCABs)."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    if key.startswith("body."):
        mapped = _map_rg_body(key, value, ada=True)
        if mapped is None:
            raise KeyError(f"unmapped RCAN key: {key}")
        yield from mapped
        return
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    raise KeyError(f"unmapped RCAN key: {key}")


def map_han_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """HAN (the reference's networks/han.py:149-226): RCAN trunk with
    plain-conv RCABs + LAM/CSAM holistic attention."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    if key.startswith("body."):
        mapped = _map_rg_body(key, value, ada=False)
        if mapped is None:
            raise KeyError(f"unmapped HAN key: {key}")
        yield from mapped
        return
    if key == "la.gamma":
        yield ("la", "gamma"), np.asarray(value)
        return
    if key == "csa.gamma":
        yield ("csa", "gamma"), np.asarray(value)
        return
    m = re.match(r"^csa\.conv\.(weight|bias)$", key)
    if m:
        if m.group(1) == "weight":
            yield ("csa", "conv3d", "kernel"), _conv3d_w(value)
        else:
            yield ("csa", "conv3d", "bias"), np.asarray(value)
        return
    m = re.match(r"^(last_conv|last)\.(weight|bias)$", key)
    if m:
        yield from _yield_conv((m.group(1),), m.group(2), value)
        return
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    raise KeyError(f"unmapped HAN key: {key}")


def map_convnext_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """ConvNeXt-SR (the reference's networks/convnet.py:10-106)."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("head",), m.group(1), value)
        return
    m = re.match(r"^body\.(\d+)\.(.+)$", key)
    if m:
        blk = f"body_{m.group(1)}"
        rest = m.group(2)
        m2 = re.match(r"dwconv\.(weight|bias)$", rest)
        if m2:
            leaf, tf = _leaf("conv", m2.group(1))
            yield (blk, "dwconv", leaf), tf(value)
            return
        m2 = re.match(r"norm\.(weight|bias)$", rest)
        if m2:
            leaf, tf = _leaf("norm", m2.group(1))
            yield (blk, "norm", leaf), tf(value)
            return
        m2 = re.match(r"(pwconv[12])\.(weight|bias)$", rest)
        if m2:
            leaf, tf = _leaf("linear", m2.group(2))
            yield (blk, m2.group(1), leaf), tf(value)
            return
        if rest == "gamma":
            yield (blk, "gamma"), np.asarray(value)
            return
        raise KeyError(f"unmapped ConvNeXt block key: {rest}")
    m = re.match(r"^tail\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(1), value)
        return
    raise KeyError(f"unmapped ConvNeXt key: {key}")


def map_dbpn_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """DBPN (the reference's networks/dbpn.py:151-243). PReLU slopes are
    skipped (fixed 0.25 on the flax side, equal to the torch init)."""
    if key.endswith("activation.weight"):
        return
    m = re.match(r"^input_conv_([01])\.(weight|bias)$", key)
    if m:
        yield from _yield_conv((f"input_conv_{m.group(1)}",), m.group(2), value)
        return
    m = re.match(r"^(up|down)_units\.(\d+)\.(.+)$", key)
    if m:
        unit = f"{m.group(1)}_{m.group(2)}"
        rest = m.group(3)
        m2 = re.match(r"(deconv(?:_[01])?)\.(weight|bias)$", rest)
        if m2:
            if m2.group(2) == "weight":
                yield (unit, m2.group(1), "deconv", "kernel"), _conv_t_w(value)
            else:
                yield (unit, m2.group(1), "deconv", "bias"), np.asarray(value)
            return
        m2 = re.match(r"(conv(?:_[01])?|input)\.(weight|bias)$", rest)
        if m2:
            yield from _yield_conv((unit, m2.group(1)), m2.group(2), value)
            return
        raise KeyError(f"unmapped DBPN unit key: {rest}")
    m = re.match(r"^reconstruction\.(weight|bias)$", key)
    if m:
        yield from _yield_conv(("reconstruction",), m.group(1), value)
        return
    raise KeyError(f"unmapped DBPN key: {key}")


def map_ipt_key(key: str, value) -> Iterable[Tuple[Path, np.ndarray]]:
    """IPT (the reference's networks/ipt.py:15-357): per-scale conv
    heads/tails + VisionTransformer body with torch MultiheadAttention
    (fused in_proj_weight split into q/k/v projections)."""
    if re.match(r"^(sub_mean|add_mean)\.", key):
        return
    m = re.match(r"^head\.(\d+)\.0\.(weight|bias)$", key)
    if m:
        yield from _yield_conv((f"head_{m.group(1)}_conv",), m.group(2), value)
        return
    m = re.match(r"^head\.(\d+)\.([12])\.(body\..+)$", key)
    if m:
        res = f"head_{m.group(1)}_res{int(m.group(2)) - 1}"
        for path, v in _map_resblock_body(m.group(3), value):
            yield (res,) + path, v
        return
    m = re.match(r"^tail\.(\d+)\.(.+)$", key)
    if m:
        yield from _map_tail(m.group(2), value, up=f"tail_{m.group(1)}_up",
                             conv=f"tail_{m.group(1)}_conv")
        return
    m = re.match(r"^body\.(.+)$", key)
    if not m:
        raise KeyError(f"unmapped IPT key: {key}")
    rest = m.group(1)
    m = re.match(r"^linear_encoding\.(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("linear", m.group(1))
        yield ("body", "linear_encoding", leaf), tf(value)
        return
    m = re.match(r"^mlp_head\.([03])\.(weight|bias)$", rest)
    if m:
        leaf, tf = _leaf("linear", m.group(2))
        yield ("body", f"mlp_head_{0 if m.group(1) == '0' else 1}", leaf), tf(value)
        return
    if rest == "query_embed.weight":
        yield ("body", "query_embed"), np.asarray(value)
        return
    if rest == "position_encoding.pe.weight":
        yield ("body", "position_encoding"), np.asarray(value)
        return
    if rest == "position_encoding.position_ids":
        return  # arange buffer, recomputed
    m = re.match(r"^(encoder|decoder)\.layers\.(\d+)\.(.+)$", rest)
    if m:
        layer = f"{m.group(1)}_{m.group(2)}"
        sub = m.group(3)
        m2 = re.match(r"(self_attn|multihead_attn)\.in_proj_weight$", sub)
        if m2:
            w = np.asarray(value)
            d = w.shape[1]
            for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                yield (("body", layer, m2.group(1), name, "kernel"),
                       _linear_w(w[i * d:(i + 1) * d]))
            return
        m2 = re.match(r"(self_attn|multihead_attn)\.out_proj\.weight$", sub)
        if m2:
            yield (("body", layer, m2.group(1), "out_proj", "kernel"),
                   _linear_w(value))
            return
        m2 = re.match(r"(linear[12])\.(weight|bias)$", sub)
        if m2:
            leaf, tf = _leaf("linear", m2.group(2))
            yield ("body", layer, m2.group(1), leaf), tf(value)
            return
        m2 = re.match(r"(norm[123])\.(weight|bias)$", sub)
        if m2:
            leaf, tf = _leaf("norm", m2.group(2))
            yield ("body", layer, m2.group(1), leaf), tf(value)
            return
        raise KeyError(f"unmapped IPT layer key: {sub}")
    raise KeyError(f"unmapped IPT body key: {rest}")


_MAPPERS = {
    "rdst": map_rdstsr_key,
    "swinir": map_swinir_key,
    "edsr": map_edsr_key,
    "srresnet": map_edsr_key,
    "mdsr": map_mdsr_key,
    "rdn": map_rdn_key,
    "srdensenet": map_srdensenet_key,
    "esrgan": map_esrgan_key,
    "zssr": map_zssr_key,
    "rcan": map_rcan_key,
    "han": map_han_key,
    "convnext": map_convnext_key,
    "dbpn": map_dbpn_key,
    "ipt": map_ipt_key,
}


# the JAX trainer's generator names for the mapper table (its ``_tl_arch``)
ARCH_ALIASES = {"swin": "swinir", "convnet-large": "convnext",
                "convnet-lite": "convnext"}


def mapper_arch(generator) -> str:
    """The ``_MAPPERS`` key of a ``feature_generator`` name."""
    name = str(generator).strip().lower()
    return ARCH_ALIASES.get(name, name)


def mapper_kwargs(paras, arch: str) -> dict:
    """The config's variant keys a mapper takes: SwinIR's upsampler and
    ZSSR's depth (``zssr_num_layers``, 8 when unset as the factory
    builds it)."""
    if arch == "swinir":
        return {"upsampler": paras.get("sir_upsampler")}
    if arch == "zssr":
        return {"num_layers": int(paras.get("zssr_num_layers", 8) or 8)}
    return {}


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            v = (v.float() if v.dtype.is_floating_point
                 and v.element_size() < 4 else v).numpy()
        out[k] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[Path, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def convert_state_dict(state_dict: Mapping, arch: str, **mapper_kwargs) -> Dict:
    """Torch state_dict (tensors or ndarrays) -> nested flax params dict.

    ``mapper_kwargs`` disambiguate arch variants (e.g. SwinIR
    ``upsampler='pixelshuffle'`` vs 'pixelshuffledirect', ZSSR
    ``num_layers``).
    """
    mapper = _MAPPERS[arch]
    sd = state_dict_to_numpy(state_dict)
    flat = {}
    for key, value in sd.items():
        for path, v in mapper(key, value, **mapper_kwargs) or ():
            flat[path] = v
    return {"params": _unflatten(flat)}


def prelu_slopes(state_dict: Mapping, arch: str,
                 **mapper_kwargs) -> Dict[str, np.ndarray]:
    """The PReLU slopes of a reference state_dict: the 1-D ``weight``
    entries that the family's mapper skips (both packages apply PReLU
    with the fixed torch-init slope 0.25)."""
    mapper = _MAPPERS[arch]
    out = {}
    for key, value in state_dict_to_numpy(state_dict).items():
        if key.endswith("weight") and value.ndim <= 1 and not list(
                mapper(key, value, **mapper_kwargs) or ()):
            out[key] = value
    return out


def verify_params_match(converted, initialized) -> None:
    """Raise if the converted tree misses/extras/mismatches any leaf."""
    a = _flatten(converted["params"])
    b = _flatten(initialized["params"])
    missing = sorted(set(b) - set(a))
    extra = sorted(set(a) - set(b))
    if missing or extra:
        raise ValueError(f"param tree mismatch; missing={missing[:5]} extra={extra[:5]} "
                         f"(total {len(missing)}/{len(extra)})")
    for k in b:
        if tuple(a[k].shape) != tuple(b[k].shape):
            raise ValueError(f"shape mismatch at {k}: {a[k].shape} vs {b[k].shape}")
