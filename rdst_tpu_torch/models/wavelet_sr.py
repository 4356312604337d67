"""Wavelet-transformer SR (counterpart of ``rdst_tpu/models/wavelet_sr.py``;
``feature_generator`` ``wtb``, ``wtr``, ``wtp`` and ``wts`` all build it).

The LR image is padded (reflect) to a multiple of 2 windows, split by a
periodized DWT (``nn.wavelet``), its four bands concatenated (4C
channels) and embedded by a conv; ``wt_depths`` residual groups (each a
Swin ``BasicLayer``, a conv and a residual) mix the wavelet tokens; a
LayerNorm and the embedding's residual; the PixelShuffle tail predicts
the 4C HR wavelet coefficients, which the IDWT turns into the image,
cropped to the scaled LR size. No mean shift, as in the JAX model.

The JAX ``BasicLayer`` here has no build resolution, so each call's
window and shift follow its own DWT grid (``resolve_ws_shift``): a grid of
one window in either direction (LR 16x12 -> grid 8x8) drops the shift in
every block. The port's blocks and kernel wrappers resolve both at each
call too, the kernel plans kept per grid. Routes by ``models.routes``,
one unit a group: its blocks on the f32 block kernel in float32, on the
fast block kernel in bfloat16 mode 'swin' (modes 'pair' / 'rdstb' raise
and name 'swin', as for SwinIR); training in bf16 on the train-pair
kernels. Module names are the flax names, each ``Conv``'s inner ``conv``
level dropped (``checkpoint.convert.export_named``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rdst_tpu_torch.models.rdst import (pad_to_window_multiple,
                                        route_by_config, to_image, to_tokens)
from rdst_tpu_torch.nn.common import Conv, UpSampler
from rdst_tpu_torch.nn.layers import BF16, LayerNorm
from rdst_tpu_torch.nn.swin import BasicLayer
from rdst_tpu_torch.nn.wavelet import dwt2, filters, idwt2

WAVELET_GENERATORS = ("wtb", "wtr", "wtp", "wts")


class WaveletSR(nn.Module):
    """DWT tokens -> Swin groups -> HR wavelet coefficients -> IDWT."""

    def __init__(self, in_chans: int = 1, sr_scale: int = 4,
                 embed_dim: int = 64, depths: Sequence[int] = (4, 4),
                 num_heads: Sequence[int] = (4, 4), window_size: int = 8,
                 mlp_ratio: float = 2.0, wavelet: str = "haar",
                 dtype: torch.dtype = torch.float32,
                 train_resolution=None):
        super().__init__()
        if dtype not in (torch.float32, BF16):
            raise NotImplementedError(
                f"WaveletSR in {dtype}: the port computes in float32 or "
                "bfloat16")
        filters(wavelet)  # raises on a wavelet it does not know
        self.dtype = dtype
        self.in_chans, self.sr_scale = int(in_chans), int(sr_scale)
        self.window_size, self.wavelet = int(window_size), wavelet
        self.train_mode = ""  # plain autograd until set_train_mode
        self.train_routes = {"pair": 0, "block": 0}
        self.train_resolution = train_resolution
        self.embed = Conv(4 * in_chans, embed_dim, 3)
        for g, depth in enumerate(depths):
            self.add_module(f"group_{g}", BasicLayer(
                embed_dim, depth, num_heads[g], window_size, mlp_ratio))
            self.add_module(f"group_{g}_conv", Conv(embed_dim, embed_dim, 3))
        self.depths = tuple(depths)
        self.norm = LayerNorm(embed_dim)
        self.tail_up = UpSampler(self.sr_scale, embed_dim)
        self.tail_coeffs = Conv(embed_dim, 4 * in_chans, 3)

    def groups(self):
        return [getattr(self, f"group_{g}") for g in range(len(self.depths))]

    def route_units(self):
        """The units a kernel route is decided for: the groups."""
        return [("group", layer) for layer in self.groups()]

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype (bf16: the input rounded to
        bf16 first, as the JAX serving path does); ``sr_scale`` is not
        read (a fixed scale)."""
        x = x.to(self.dtype)
        x, (h0, w0) = pad_to_window_multiple(x, 2 * self.window_size)
        ll, bands = dwt2(x, self.wavelet)
        wav = torch.cat([ll] + [bands[..., i] for i in range(3)], dim=-1)
        feat = self.embed(wav)
        tokens, x_size = to_tokens(feat)
        for g, layer in enumerate(self.groups()):
            conv = getattr(self, f"group_{g}_conv")
            y = conv(to_image(layer(tokens, x_size), x_size))
            tokens = to_tokens(y)[0] + tokens
        feat = to_image(self.norm(tokens), x_size) + feat
        coeffs = self.tail_coeffs(self.tail_up(feat))
        c = self.in_chans
        bands_hr = torch.stack([coeffs[..., (i + 1) * c:(i + 2) * c]
                                for i in range(3)], dim=-1)
        out = idwt2(coeffs[..., :c], bands_hr, self.wavelet)
        s = self.sr_scale
        return out[:, : h0 * s, : w0 * s, :]


def make_wavelet_sr(paras, mean=None, std=None,
                    dtype=torch.float32) -> WaveletSR:
    """The JAX package's ``make_wavelet_sr``: ``wt_embed_dim`` (64),
    ``wt_depths`` ((4, 4)), ``wt_num_heads`` ((4, 4)), ``wt_window_size``
    (8), ``wt_mlp_ratio`` (2.0), ``wavelet_kernel`` ('haar'); ``mean`` /
    ``std`` are not used. The training patch (``patch_size`` LR, padded
    to whole pairs of windows) gives the DWT grid the bf16 training
    routes are decided at. Routes by ``route_by_config``."""
    ws = int(paras.get("wt_window_size", 8))
    lr = int(paras.patch_size)
    grid = -(-lr // (2 * ws)) * ws
    model = WaveletSR(
        in_chans=paras.input_channel,
        sr_scale=int(paras.sr_scale),
        embed_dim=int(paras.get("wt_embed_dim", 64)),
        depths=tuple(paras.get("wt_depths", (4, 4))),
        num_heads=tuple(paras.get("wt_num_heads", (4, 4))),
        window_size=ws,
        mlp_ratio=float(paras.get("wt_mlp_ratio", 2.0)),
        wavelet=paras.get("wavelet_kernel", "haar"),
        dtype=dtype,
        train_resolution=(grid, grid),
    )
    return route_by_config(model, paras)
