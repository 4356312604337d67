"""SwinIR (counterpart of ``rdst_tpu/models/swinir.py``): RSTBs of Swin
blocks between a head conv and an upsampler.

Module names give the reference SwinIR state_dict keys (the ones
``checkpoint.convert.export_swinir`` writes): ``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{k}...``,
``layers.{i}.conv`` (or ``conv.0/2/4`` for '3conv'), ``norm``,
``conv_after_body``, then ``conv_before_upsample.0`` + ``upsample.{2i}`` +
``conv_last`` ('pixelshuffle', SwinIR-std), ``upsample.0``
('pixelshuffledirect', SwinIR-light), ``conv_before_upsample.0`` +
``conv_up1`` + ``conv_up2`` + ``conv_hr`` + ``conv_last`` ('nearest+conv',
the real-world x4 head: nearest x2 before each ``conv_up``), or
``conv_last`` alone ('' : denoise / artifact removal, the input added back,
the output at the input's size); ``absolute_pos_embed`` with ``sir_ape``.
Layouts are NHWC and (B, L, C) tokens; the model computes in its ``dtype``
as ``models.rdst`` does.

The JAX factory's build-resolution quirk is kept: ``make_swinir`` builds
every block at ``img_size = (patch_size // sr_scale // window + 1) *
window``, which is one window (8) for the shipped configs, so
``resolve_ws_shift`` gives every block shift 0 -- SwinIR as shipped runs
no shifted window. Stochastic depth reaches the blocks (linear over all
of them up to ``sir_drop_path_rate``), as the JAX RSTB passes it on.
Routes are decided once by ``models.routes``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rdst_tpu_torch.models.rdst import (add_position_table, conv_stack,
                                        fit_position_table,
                                        pad_to_window_multiple,
                                        position_table, route_by_config,
                                        to_image, to_tokens)
from rdst_tpu_torch.nn.common import Conv, PixelShuffle, UpSampler
from rdst_tpu_torch.nn.layers import (BF16, Dropout, LayerNorm, LeakyReLU,
                                      constant_buffer)
from rdst_tpu_torch.nn.swin import BasicLayer

UPSAMPLERS = ("pixelshuffle", "pixelshuffledirect", "nearest+conv", "")


class RSTB(nn.Module):
    """Residual Swin Transformer Block: a BasicLayer, a conv, a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = (),
                 resi_connection: str = "1conv",
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True):
        super().__init__()
        self.residual_group = BasicLayer(
            dim, depth, num_heads, window_size, mlp_ratio, qkv_bias,
            qk_scale, build_resolution, layer_norm, drop, attn_drop,
            tuple(drop_path))
        self.conv = conv_stack(dim, dim, resi_connection)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        y = self.residual_group(x, x_size)
        y, _ = to_tokens(self.conv(to_image(y, x_size)))
        return y + x


class _PatchEmbed(nn.Module):
    """Holds the patch-embedding LayerNorm (state_dict ``patch_embed.norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class SwinIR(nn.Module):
    """SwinIR; forward maps NHWC LR (B, H, W, C) to HR."""

    def __init__(self, in_chans: int = 1, embed_dim: int = 96,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, ape: bool = False,
                 patch_norm: bool = True,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv", num_feat: int = 64,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True, dtype: torch.dtype = torch.float32,
                 train_resolution: Optional[Tuple[int, int]] = None):
        super().__init__()
        if dtype not in (torch.float32, BF16):
            raise NotImplementedError(
                f"SwinIR in {dtype}: the port computes in float32 or bfloat16")
        if upsampler not in UPSAMPLERS:
            raise ValueError(f"sir_upsampler {upsampler!r}: expected one "
                             f"of {UPSAMPLERS}")
        if upsampler == "nearest+conv" and int(upscale) != 4:
            raise ValueError(f"sir_upsampler 'nearest+conv' is x4 only (as "
                             f"in the reference), not x{upscale}")
        self.dtype = dtype
        self.window_size = int(window_size)
        self.upscale, self.upsampler = int(upscale), upsampler
        self.img_range = float(img_range)
        # the DIV2K RGB mean for 3 channels, zero otherwise (:646-651)
        self.rgb_mean = ((0.4488, 0.4371, 0.4040) if in_chans == 3
                         else (0.0,) * in_chans)
        constant_buffer(self, "rgb_mean_value", self.rgb_mean)
        self.train_mode = ""  # plain autograd until set_train_mode
        self.train_routes = {"pair": 0, "block": 0}
        self.train_resolution = train_resolution or build_resolution
        self.conv_first = Conv(in_chans, embed_dim, 3)
        self.patch_embed = (_PatchEmbed(embed_dim)
                            if patch_norm and layer_norm else None)
        self.absolute_pos_embed = (position_table(
            self.train_resolution, self.window_size, embed_dim) if ape
            else None)
        self.pos_drop = Dropout(drop_rate)
        dpr = [float(d) for d in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = nn.ModuleList([
            RSTB(embed_dim, depths[i], num_heads[i], window_size, mlp_ratio,
                 qkv_bias, qk_scale, drop_rate, attn_drop_rate,
                 dpr[sum(depths[:i]):sum(depths[:i + 1])], resi_connection,
                 build_resolution, layer_norm)
            for i in range(len(depths))])
        self.norm = LayerNorm(embed_dim) if layer_norm else None
        self.conv_after_body = Conv(embed_dim, embed_dim, 3)
        if upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(
                Conv(embed_dim, num_feat, 3), LeakyReLU(0.01))
        if upsampler == "pixelshuffle":
            self.upsample = UpSampler(self.upscale, num_feat)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                Conv(embed_dim, self.upscale ** 2 * in_chans, 3),
                PixelShuffle(self.upscale))
        elif upsampler == "nearest+conv":
            self.conv_up1 = Conv(num_feat, num_feat, 3)
            self.conv_up2 = Conv(num_feat, num_feat, 3)
            self.conv_hr = Conv(num_feat, num_feat, 3)
            self.lrelu = LeakyReLU(0.2)
        if upsampler != "pixelshuffledirect":
            self.conv_last = Conv(embed_dim if upsampler == "" else num_feat,
                                  in_chans, 3)
        # the denoise head keeps the input's size
        self.out_scale = 1 if upsampler == "" else self.upscale

    def route_units(self):
        """The units a kernel route is decided for: the RSTBs."""
        return [("RSTB", layer) for layer in self.layers]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        fit_position_table(self.absolute_pos_embed, state_dict,
                           prefix + "absolute_pos_embed")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        tokens, x_size = to_tokens(x)
        if self.patch_embed is not None:
            tokens = self.patch_embed.norm(tokens)
        if self.absolute_pos_embed is not None:
            tokens = add_position_table(tokens, self.absolute_pos_embed,
                                        x_size, "sir_ape")
        tokens = self.pos_drop(tokens)
        for layer in self.layers:
            tokens = layer(tokens, x_size)
        if self.norm is not None:
            tokens = self.norm(tokens)
        return to_image(tokens, x_size)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype (bf16: the input rounded to
        bf16 first, as the JAX serving path does); ``sr_scale`` is not
        read (SwinIR has a fixed scale)."""
        x = x.to(self.dtype)
        x, (h0, w0) = pad_to_window_multiple(x, self.window_size)
        mean = self.rgb_mean_value.to(x.dtype)
        x = (x - mean) * self.img_range
        first = self.conv_first(x)
        res = self.conv_after_body(self.forward_features(first)) + first
        if self.upsampler == "pixelshuffle":
            x = self.conv_last(self.upsample(self.conv_before_upsample(res)))
        elif self.upsampler == "pixelshuffledirect":
            x = self.upsample(res)
        elif self.upsampler == "nearest+conv":
            y = self.conv_before_upsample(res)
            y = self.lrelu(self.conv_up1(_nearest2(y)))
            y = self.lrelu(self.conv_up2(_nearest2(y)))
            x = self.conv_last(self.lrelu(self.conv_hr(y)))
        else:  # denoise: the (normalized) input added back
            x = x + self.conv_last(res)
        x = x / self.img_range + mean
        s = self.out_scale
        return x[:, : h0 * s, : w0 * s, :]


def _nearest2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 of NHWC (``jnp.repeat`` on H, then W)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def make_swinir(paras, mean=None, std=None, dtype=torch.float32) -> SwinIR:
    """Factory reading the ``sir_*`` config keys (the JAX package's
    ``make_swinir``; ``mean``/``std`` are not used: SwinIR normalizes by
    its own mean and ``sir_img_range``). Routes by ``route_by_config``,
    as in ``make_rdst``."""
    ws = paras.sir_window_size
    img_size = int(paras.patch_size // paras.sr_scale // ws + 1) * ws
    lr_patch = int(paras.patch_size)
    model = SwinIR(
        build_resolution=(img_size, img_size),
        train_resolution=(lr_patch, lr_patch),
        in_chans=paras.input_channel,
        embed_dim=paras.sir_embed_dim,
        depths=tuple(paras.sir_swintr_layers),
        num_heads=tuple(paras.sir_num_heads),
        window_size=ws,
        mlp_ratio=paras.sir_hidden_ratio,
        qkv_bias=paras.sir_qkv_bias,
        qk_scale=paras.sir_qk_scale,
        drop_rate=float(paras.sir_drop_rate or 0.0),
        attn_drop_rate=float(paras.sir_attn_drop_rate or 0.0),
        drop_path_rate=float(paras.sir_drop_path_rate or 0.0),
        ape=bool(paras.sir_ape),
        patch_norm=paras.sir_patch_norm,
        layer_norm=bool(paras.get("sir_layer_norm", True)),
        upscale=int(paras.sr_scale),
        img_range=paras.sir_img_range,
        upsampler=paras.sir_upsampler,
        resi_connection=paras.sir_res_connection,
        dtype=dtype,
    )
    return route_by_config(model, paras)
