"""ESTSR -- residual-in-residual dense Swin transformer SR (counterpart
of ``rdst_tpu/models/estsr.py``; ``feature_generator = 'estsr'``).

MeanShift -> head conv -> ``estsr_num_rrdb_blocks`` RRDSTBs (each
``estsr_rrdb_depths[i]`` RDSTBs, a conv and a scaled residual) ->
LayerNorm -> ``global_res_scale`` x the image + the head features ->
PixelShuffle (or the scale-free MetaUpSampler) tail. As in the JAX model
there is no ``conv_after_body`` (the reference declares one and never
applies it), the patch LayerNorm and the final one are always there, and
the per-block config lists are read cyclically (``i % len``). Module
names give the flax names (``body.i.body.j`` is ``body_i/body_j``); the
route units are the RDSTBs inside each RRDSTB.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rdst_tpu_torch.models.meta_upscale import scale_value
from rdst_tpu_torch.models.rdst import (RRDSTB, SRFrame, route_by_config,
                                        to_image)
from rdst_tpu_torch.nn.layers import LayerNorm


class ESTSR(SRFrame):
    """ESTSR; forward maps NHWC LR (B, H, W, C) to HR."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 2,
                 embed_dim: int = 60,
                 dense_layer_depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: Sequence[int] = (4, 4, 4, 4),
                 rdb_depths: Sequence[int] = (3, 3, 3, 3),
                 rrdb_depths: Sequence[int] = (3, 3, 3, 3),
                 num_rrdb_blocks: int = 4, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, ape: bool = False,
                 patch_norm: bool = True, resi_connection: str = "1conv",
                 growth_rate: int = 30, dense_scale: float = 1.0,
                 dim_modify_mode: str = "tail",
                 rdb_residual_scale: float = 1.0,
                 rrdb_residual_scale: float = 1.0,
                 global_res_scale: float = 1.0,
                 mean: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,),
                 scale_free: bool = False, pre_norm: bool = False,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._head(in_chans, embed_dim, window_size, mean, std, patch_norm,
                   ape, build_resolution, dtype)
        self.global_res_scale = float(global_res_scale)

        def cyc(seq, i):
            return seq[i % len(seq)]

        self.body = nn.ModuleList([
            RRDSTB(embed_dim, cyc(rrdb_depths, i), cyc(dense_layer_depths, i),
                   cyc(num_heads, i), cyc(window_size, i), mlp_ratio,
                   resi_connection, growth_rate, dense_scale,
                   dim_modify_mode, cyc(rdb_depths, i), rdb_residual_scale,
                   rrdb_residual_scale, pre_norm, build_resolution)
            for i in range(int(num_rrdb_blocks))])
        self.norm = LayerNorm(embed_dim)
        self._tail(in_chans, sr_scale, embed_dim, drop_rate, scale_free)

    def rdstbs(self):
        return [b for rr in self.body for b in rr.body]

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype; ``sr_scale`` is read by a
        scale-free model only, which needs it."""
        scale = scale_value(sr_scale) if self.scale_free else None
        x, tokens, x_size, hw0 = self._embed(x)
        for block in self.body:
            tokens = block(tokens, x_size)
        res = to_image(self.norm(tokens), x_size) * self.global_res_scale
        return self._upsample(res + x, scale, hw0)


def make_estsr(paras, mean=None, std=None, dtype=torch.float32) -> ESTSR:
    """The JAX package's ``make_estsr``: the ``rdst_*`` keys with the
    ``estsr_*`` ones (``estsr_num_rrdb_blocks``, default the number of
    RDSTBs the config lists; ``estsr_rrdb_depths``, default 3 each;
    ``estsr_rrdb_residual_scale``, default 1). Routes by
    ``route_by_config``."""
    c = paras.input_channel
    model = ESTSR(
        in_chans=c,
        sr_scale=int(paras.sr_scale),
        embed_dim=paras.rdst_embed_dim,
        dense_layer_depths=tuple(paras.rdst_dense_layer_depths),
        num_heads=tuple(paras.rdst_num_heads),
        window_size=tuple(paras.rdst_window_size),
        rdb_depths=tuple(paras.rdst_rdb_depths),
        rrdb_depths=tuple(paras.get("estsr_rrdb_depths",
                                    [3] * len(paras.rdst_rdb_depths))),
        num_rrdb_blocks=int(paras.get("estsr_num_rrdb_blocks",
                                      len(paras.rdst_rdb_depths))),
        mlp_ratio=paras.swin_hidden_ratio,
        drop_rate=float(paras.get("swin_drop_rate", 0.0) or 0.0),
        ape=bool(paras.rdst_ape),
        patch_norm=paras.rdst_patch_norm,
        resi_connection=paras.rdst_res_connection,
        growth_rate=paras.rdst_growth_rate,
        dense_scale=paras.rdst_dense_scale,
        dim_modify_mode=paras.rdst_dim_modify_mode,
        rdb_residual_scale=paras.rdst_rdb_residual_scale,
        rrdb_residual_scale=float(paras.get("estsr_rrdb_residual_scale", 1.0)),
        global_res_scale=paras.rdst_global_res_scale,
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        scale_free=bool(paras.scale_free),
        pre_norm=paras.rdst_pre_norm,
        build_resolution=(paras.patch_size // paras.swin_patch_size,) * 2,
        dtype=dtype,
    )
    return route_by_config(model, paras)
