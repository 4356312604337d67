"""RDST -- Residual Dense Swin Transformer SR (counterpart of
``rdst_tpu/models/rdst.py``).

* DenseSTLayer (DSTL): a Swin block pair (shift 0 / ws//2) + a linear
  dim adapter at 'head' or 'tail' + a dense channel concat;
* RDSTB: DSTLs with the input dim growing by growth_rate, then a 3x3
  conv bottleneck back to embed_dim and a scaled residual;
* RDSTSR: mean-shift -> head conv -> RDSTBs over tokens -> LayerNorm ->
  conv_after_body -> global residual -> PixelShuffle tail.

Module names give the reference RDSTSR state_dict keys (the ones
``checkpoint.convert.export_rdstsr`` writes). Layouts are NHWC and
(B, L, C) tokens, as in the JAX package. Inference only.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.nn.common import Conv, MeanShift, UpSampler
from rdst_tpu_torch.nn.layers import LayerNorm
from rdst_tpu_torch.nn.swin import BasicLayer, set_block_kernels


def to_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B,H,W,C) -> ((B,L,C), (H,W)); row-major L."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c), (h, w)


def to_image(x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, x_size[0], x_size[1], c)


def _lcm_all(sizes) -> int:
    """LCM of the per-block window sizes."""
    out = 1
    for s in sizes:
        out = math.lcm(out, int(s))
    return out


def pad_to_window_multiple(x: torch.Tensor, multiple: int
                           ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Reflect-pad H, W of an NHWC batch up to a window multiple; the
    caller crops the output back."""
    b, h, w, c = x.shape
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                  mode="reflect").permute(0, 2, 3, 1)
    return x, (h, w)


def _adapter(in_dim: int, out_dim: int, pre_norm: bool,
             layer_norm: bool) -> nn.Sequential:
    """[LN(in), Linear] when pre_norm, else [Linear, LN(out)]; the
    LayerNorm is an Identity when the model has no norms."""
    if pre_norm:
        return nn.Sequential(LayerNorm(in_dim) if layer_norm else nn.Identity(),
                             nn.Linear(in_dim, out_dim))
    return nn.Sequential(nn.Linear(in_dim, out_dim),
                         LayerNorm(out_dim) if layer_norm else nn.Identity())


class DenseSTLayer(nn.Module):
    """DSTL: Swin pair + dim adapter + dense concat."""

    def __init__(self, input_dim: int, growth_rate: int, depth: int = 2,
                 num_heads: int = 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dense_scale: float = 1.0,
                 dim_modify_mode: str = "tail", pre_norm: bool = False,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True):
        super().__init__()
        if growth_rate % num_heads or input_dim % num_heads:
            raise ValueError("input_dim and growth_rate must divide by heads")
        self.dense_scale = dense_scale
        need_adapter = input_dim != growth_rate
        hidden_dim = growth_rate if dim_modify_mode == "head" else input_dim
        self.head = (_adapter(input_dim, growth_rate, pre_norm, layer_norm)
                     if dim_modify_mode == "head" and need_adapter else None)
        self.body = BasicLayer(hidden_dim, depth, num_heads, window_size,
                               mlp_ratio, qkv_bias, qk_scale,
                               build_resolution, layer_norm)
        self.tail = (_adapter(hidden_dim, growth_rate, pre_norm, layer_norm)
                     if dim_modify_mode == "tail" and need_adapter else None)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        shortcut = x
        if self.head is not None:
            x = self.head(x)
        x = self.body(x, x_size)
        if self.tail is not None:
            x = self.tail(x)
        if self.dense_scale != 1.0:
            x = x * self.dense_scale
        return torch.cat([shortcut, x], dim=2)


class RDSTB(nn.Module):
    """Residual dense block of DSTLs."""

    def __init__(self, input_dim: int, layer_depth: int = 2,
                 num_heads: int = 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None,
                 resi_connection: str = "1conv", growth_rate: int = 30,
                 dense_scale: float = 1.0, dim_modify_mode: str = "tail",
                 num_blocks: int = 3, residual_scale: float = 1.0,
                 pre_norm: bool = False,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(
                f"resi_connection {resi_connection!r}: only '1conv' (every "
                "shipped RDST config) is ported")
        self.residual_scale = residual_scale
        self.body = nn.ModuleList([
            DenseSTLayer(input_dim + i * growth_rate, growth_rate,
                         layer_depth, num_heads, window_size, mlp_ratio,
                         qkv_bias, qk_scale, dense_scale, dim_modify_mode,
                         pre_norm, build_resolution, layer_norm)
            for i in range(int(num_blocks))])
        self.conv = Conv(input_dim + int(num_blocks) * growth_rate,
                         input_dim, 3)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        shortcut = x
        for layer in self.body:
            x = layer(x, x_size)
        y, _ = to_tokens(self.conv(to_image(x, x_size)))
        if self.residual_scale != 1.0:
            y = y * self.residual_scale
        return y + shortcut


class _PatchEmbed(nn.Module):
    """Holds the patch-embedding LayerNorm (state_dict ``patch_embed.norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class RDSTSR(nn.Module):
    """Full RDST SR network; forward maps NHWC LR (B, H, W, C) to HR."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 embed_dim: int = 60,
                 dense_layer_depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: Sequence[int] = (4, 4, 4, 4),
                 rdb_depths: Sequence[int] = (3, 3, 3, 3),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, patch_norm: bool = True,
                 resi_connection: str = "1conv", growth_rate: int = 30,
                 dense_scale: float = 1.0, dim_modify_mode: str = "tail",
                 rdb_residual_scale: float = 1.0,
                 global_res_scale: float = 1.0,
                 mean: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,),
                 pre_norm: bool = False, layer_norm: bool = True,
                 feature_last_operation: bool = False,
                 build_resolution: Optional[Tuple[int, int]] = None):
        super().__init__()
        if not (len(rdb_depths) == len(window_size) == len(num_heads)
                == len(dense_layer_depths)):
            raise ValueError("per-RDSTB config lists differ in length")
        if feature_last_operation and resi_connection != "1conv":
            raise NotImplementedError("conv_after_body: only '1conv' is ported")
        self.sr_scale = int(sr_scale)
        self.window_size = tuple(window_size)
        self.layer_norm = layer_norm
        self.patch_norm = patch_norm
        self.global_res_scale = global_res_scale
        self.mean, self.std = tuple(mean), tuple(std)
        self.sub_mean = MeanShift(mean, std, "sub")
        self.add_mean = MeanShift(mean, std, "add")
        self.head = Conv(in_chans, embed_dim, 3)
        self.patch_embed = (_PatchEmbed(embed_dim)
                            if patch_norm and layer_norm else None)
        self.body = nn.ModuleList([
            RDSTB(embed_dim, dense_layer_depths[i], num_heads[i],
                  window_size[i], mlp_ratio, qkv_bias, qk_scale,
                  resi_connection, growth_rate, dense_scale, dim_modify_mode,
                  rdb_depths[i], rdb_residual_scale, pre_norm,
                  build_resolution, layer_norm)
            for i in range(len(rdb_depths))])
        self.norm = LayerNorm(embed_dim) if layer_norm else None
        self.conv_after_body = (Conv(embed_dim, embed_dim, 3)
                                if feature_last_operation else None)
        self.tail = nn.Sequential(
            UpSampler(self.sr_scale, embed_dim) if self.sr_scale > 1
            else nn.Identity(),
            Conv(embed_dim, in_chans, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, (h0, w0) = pad_to_window_multiple(x, _lcm_all(self.window_size))
        x = self.head(self.sub_mean(x))
        tokens, x_size = to_tokens(x)
        if self.patch_embed is not None:
            tokens = self.patch_embed.norm(tokens)
        for block in self.body:
            tokens = block(tokens, x_size)
        if self.norm is not None:
            tokens = self.norm(tokens)
        res = to_image(tokens, x_size)
        if self.global_res_scale != 1.0:
            res = res * self.global_res_scale
        if self.conv_after_body is not None:
            res = self.conv_after_body(res)
        out = self.add_mean(self.tail(res + x))
        s = self.sr_scale
        return out[:, : h0 * s, : w0 * s, :]


def make_rdst(paras, mean=None, std=None, dtype=torch.float32) -> RDSTSR:
    """Factory keyed off the reference config names (the JAX package's
    ``make_rdst``). The kernel mode (``pallas_kernels``, else
    ``RDST_TORCH_KERNELS``) is resolved here, once: the model keeps it as
    ``kernel_mode`` and its Swin blocks as ``use_kernel``."""
    from rdst_tpu_torch.kernels.window_attention import kernel_flags

    if dtype != torch.float32:
        raise NotImplementedError(
            f"RDST in {dtype}: this slice runs float32 only; bf16 inference "
            "comes with the fused_rdstb / fused_swin_pair slice")
    if paras.rdst_global_bottleneck:
        raise NotImplementedError(
            "rdst_global_bottleneck (RDST-N) comes with the model-zoo slice")
    if paras.scale_free:
        raise NotImplementedError(
            "scale_free RDST (MetaSR upsampler) comes with the model-zoo slice")
    if paras.rdst_ape:
        raise NotImplementedError(
            "rdst_ape (absolute position embedding) is not ported; no "
            "shipped RDST config sets it")
    nc = paras.input_channel
    model = RDSTSR(
        in_chans=nc,
        sr_scale=int(paras.sr_scale),
        embed_dim=paras.rdst_embed_dim,
        dense_layer_depths=tuple(paras.rdst_dense_layer_depths),
        num_heads=tuple(paras.rdst_num_heads),
        window_size=tuple(paras.rdst_window_size),
        rdb_depths=tuple(paras.rdst_rdb_depths),
        mlp_ratio=paras.swin_hidden_ratio,
        qkv_bias=paras.swin_qkv_bias,
        qk_scale=paras.swin_qk_scale,
        patch_norm=paras.rdst_patch_norm,
        layer_norm=bool(paras.get("rdst_layer_norm", True)),
        resi_connection=paras.rdst_res_connection,
        growth_rate=paras.rdst_growth_rate,
        dense_scale=paras.rdst_dense_scale,
        dim_modify_mode=paras.rdst_dim_modify_mode,
        rdb_residual_scale=paras.rdst_rdb_residual_scale,
        global_res_scale=paras.rdst_global_res_scale,
        mean=tuple(mean) if mean is not None else (0.0,) * nc,
        std=tuple(std) if std is not None else (1.0,) * nc,
        pre_norm=paras.rdst_pre_norm,
        feature_last_operation=paras.rdst_feature_last_operation,
        build_resolution=(paras.patch_size // paras.swin_patch_size,) * 2,
    )
    model.kernel_mode = kernel_flags(paras).kernels
    set_block_kernels(model, bool(model.kernel_mode))
    return model
