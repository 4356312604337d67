"""RDSTSR_N -- RDST with an RDN-style global bottleneck (counterpart of
``rdst_tpu/models/rdst_n.py``), built by ``make_rdst`` when
``rdst_global_bottleneck`` is set.

Every RDSTB's output is concatenated on the channel axis (8 x 60 = 480
channels at RDST-E1's width) and reduced by the ``mlp`` bottleneck (two
Linear layers, ``torch.matmul`` as the JAX package leaves them to XLA) or
the ``conv`` one (1x1 + 3x3), then the scaled global residual and the
tail. The JAX model's quirks are kept: no final LayerNorm and no
``conv_after_body`` (the reference builds both and never applies them),
the patch LayerNorm whatever ``rdst_layer_norm`` says, LayerNorms in
every RDSTB. Module names give the flax names (``bottleneck_0`` /
``bottleneck_1`` are ``bottleneck.0`` / ``bottleneck.1``) beside
RDSTSR's; routes as RDSTSR's, one unit an RDSTB.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rdst_tpu_torch.models.meta_upscale import scale_value
from rdst_tpu_torch.models.rdst import (RDSTB, SRFrame, route_by_config,
                                        to_image)
from rdst_tpu_torch.nn.common import Conv
from rdst_tpu_torch.nn.layers import Linear

BOTTLENECK_MODES = ("mlp", "conv")


class RDSTSR_N(SRFrame):
    """RDST-N; forward maps NHWC LR (B, H, W, C) to HR."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 embed_dim: int = 60,
                 dense_layer_depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: Sequence[int] = (4, 4, 4, 4),
                 rdb_depths: Sequence[int] = (3, 3, 3, 3),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop: float = 0.0, ape: bool = False,
                 patch_norm: bool = True, resi_connection: str = "1conv",
                 growth_rate: int = 30, dense_scale: float = 1.0,
                 dim_modify_mode: str = "tail",
                 rdb_residual_scale: float = 1.0,
                 global_res_scale: float = 1.0,
                 mean: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,),
                 scale_free: bool = False, pre_norm: bool = False,
                 global_bottleneck_ratio: float = 1.0,
                 global_bottleneck_mode: str = "mlp",
                 build_resolution: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        final = int(embed_dim * global_bottleneck_ratio)
        if final != embed_dim:
            raise ValueError(
                f"rdst_global_bottleneck_ratio {global_bottleneck_ratio}: the "
                f"bottleneck's {final} channels cannot be added to the "
                f"head's {embed_dim} (the JAX RDSTSR_N fails there too); "
                "only a ratio that keeps the width builds")
        if global_bottleneck_mode not in BOTTLENECK_MODES:
            raise ValueError(f"unknown bottleneck mode "
                             f"{global_bottleneck_mode!r}: expected one of "
                             f"{BOTTLENECK_MODES}")
        if not (len(rdb_depths) == len(window_size) == len(num_heads)
                == len(dense_layer_depths)):
            raise ValueError("per-RDSTB config lists differ in length")
        self._head(in_chans, embed_dim, window_size, mean, std, patch_norm,
                   ape, build_resolution, dtype)
        self.global_res_scale = float(global_res_scale)
        self.bottleneck_mode = global_bottleneck_mode
        self.body = nn.ModuleList([
            RDSTB(embed_dim, dense_layer_depths[i], num_heads[i],
                  window_size[i], mlp_ratio, qkv_bias, qk_scale,
                  resi_connection, growth_rate, dense_scale, dim_modify_mode,
                  rdb_depths[i], rdb_residual_scale, pre_norm,
                  build_resolution, True, drop_rate, attn_drop)
            for i in range(len(rdb_depths))])
        cat = embed_dim * len(rdb_depths)
        self.bottleneck = (
            nn.Sequential(Linear(cat, final), Linear(final, final))
            if global_bottleneck_mode == "mlp"
            else nn.Sequential(Conv(cat, final, 1), Conv(final, final, 3)))
        self._tail(in_chans, sr_scale, final, drop_rate, scale_free)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype; ``sr_scale`` is read by a
        scale-free model only, which needs it."""
        scale = scale_value(sr_scale) if self.scale_free else None
        x, tokens, x_size, hw0 = self._embed(x)
        maps = []
        for block in self.body:
            tokens = block(tokens, x_size)
            maps.append(tokens)
        cat = torch.cat(maps, dim=2)
        if self.bottleneck_mode == "mlp":
            res = to_image(self.bottleneck(cat), x_size)
        else:
            res = self.bottleneck(to_image(cat, x_size))
        return self._upsample(res * self.global_res_scale + x, scale, hw0)


def make_rdst_n(paras, mean=None, std=None, dtype=torch.float32) -> RDSTSR_N:
    """The JAX package's ``make_rdst_n``: the ``rdst_*`` keys with
    ``rdst_global_bottleneck_ratio`` and ``rdst_global_bottleneck_mode``
    ('mlp' unless set). Routes by ``route_by_config``."""
    c = paras.input_channel
    model = RDSTSR_N(
        in_chans=c,
        sr_scale=int(paras.sr_scale),
        embed_dim=paras.rdst_embed_dim,
        dense_layer_depths=tuple(paras.rdst_dense_layer_depths),
        num_heads=tuple(paras.rdst_num_heads),
        window_size=tuple(paras.rdst_window_size),
        rdb_depths=tuple(paras.rdst_rdb_depths),
        mlp_ratio=paras.swin_hidden_ratio,
        qkv_bias=paras.swin_qkv_bias,
        qk_scale=paras.swin_qk_scale,
        drop_rate=float(paras.get("swin_drop_rate", 0.0) or 0.0),
        attn_drop=float(paras.get("swin_attn_drop_rate", 0.0) or 0.0),
        ape=bool(paras.rdst_ape),
        patch_norm=paras.rdst_patch_norm,
        resi_connection=paras.rdst_res_connection,
        growth_rate=paras.rdst_growth_rate,
        dense_scale=paras.rdst_dense_scale,
        dim_modify_mode=paras.rdst_dim_modify_mode,
        rdb_residual_scale=paras.rdst_rdb_residual_scale,
        global_res_scale=paras.rdst_global_res_scale,
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        scale_free=bool(paras.scale_free),
        pre_norm=paras.rdst_pre_norm,
        global_bottleneck_ratio=paras.rdst_global_bottleneck_ratio,
        global_bottleneck_mode=paras.get("rdst_global_bottleneck_mode", "mlp"),
        build_resolution=(paras.patch_size // paras.swin_patch_size,) * 2,
        dtype=dtype,
    )
    return route_by_config(model, paras)
