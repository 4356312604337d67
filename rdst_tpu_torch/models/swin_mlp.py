"""Swin-MLP SR (counterpart of ``rdst_tpu/models/swin_mlp.py``;
``feature_generator`` ``swinmlp`` / ``swin-mlp``).

A :class:`SwinMLPBlock` mixes the tokens of each window by a per-head
spatial linear (window area x window area weights a head, the JAX
``einsum``) in place of attention: a shifted block pads the image with
zeros (``ws - shift`` before, ``shift`` after; not a roll), mixes, and
crops. Where ``min(h, w) <= ws`` the JAX block shrinks its window to
``min(h, w)`` and drops the shift: at ``min(h, w) == ws`` (a grid one
window tall or wide) it runs unshifted; below, its weights no longer fit,
the JAX apply fails, and the port raises and names the sizes. The SR wrapper
has SwinIR's topology: conv head -> residual groups of blocks (shift 0 /
ws // 2 alternating, stochastic depth linear over all blocks) -> LayerNorm
-> conv -> global residual -> PixelShuffle tail. No kernel of the port:
plain PyTorch, as the JAX package leaves it to XLA (``route_units()`` is
empty). Module names are the flax names, each ``Conv``'s inner ``conv``
level dropped (``checkpoint.convert.export_named``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.models.rdst import (pad_to_window_multiple, to_image,
                                        to_tokens)
from rdst_tpu_torch.nn.common import Conv, UpSampler
from rdst_tpu_torch.nn.layers import BF16, DropPath, LayerNorm, Mlp
from rdst_tpu_torch.nn.swin import window_partition, window_reverse


class SwinMLPBlock(nn.Module):
    """LN -> (zero-padded shift) -> per-head spatial linear in windows ->
    crop -> residual; LN -> MLP -> residual. Token input (B, L, C)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.shift_size = window_size, shift_size
        n = window_size * window_size
        self.norm1 = LayerNorm(dim)
        self.spatial_mlp_kernel = nn.Parameter(torch.zeros(num_heads, n, n))
        self.spatial_mlp_bias = nn.Parameter(torch.zeros(num_heads, n))
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)
        self.drop_path = DropPath(drop_path)

    def _mix(self, windows: torch.Tensor) -> torch.Tensor:
        """(B*nW, N, C) -> the same, token t' of head h the sum over t of
        W[h, t', t] token t, plus the head's bias at t'."""
        b_, n, c = windows.shape
        nh = self.num_heads
        wh = windows.reshape(b_, n, nh, c // nh).transpose(1, 2)
        w, bias = self.spatial_mlp_kernel, self.spatial_mlp_bias
        if wh.dtype == BF16:  # a bf16 product, its bf16 bias added
            y = torch.matmul(w.to(BF16).float(), wh.float()).to(BF16)
            y = (y.float() + bias.to(BF16).float()[None, :, :, None]
                 ).to(BF16)
        else:
            y = torch.matmul(w, wh) + bias[None, :, :, None]
        return y.transpose(1, 2).reshape(b_, n, c)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        b, l, c = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(h, w) <= ws:  # the JAX block's clamp
            ws, shift = min(h, w), 0
        if ws != self.window_size:
            raise ValueError(
                f"Swin-MLP block of window {self.window_size} on a {h}x{w} "
                f"input: the JAX block shrinks its window to {ws} there, "
                f"where its {self.window_size ** 2}-token spatial weights do "
                f"not apply (the JAX apply fails); give it at least "
                f"{self.window_size} rows and columns")
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            pl, pr = ws - shift, shift
            x = F.pad(x, (0, 0, pl, pr, pl, pr))
        hh, ww = x.shape[1:3]
        windows = window_partition(x, ws).reshape(-1, ws * ws, c)
        x = window_reverse(self._mix(windows).reshape(-1, ws, ws, c), ws,
                           hh, ww)
        if shift > 0:
            x = x[:, pl:hh - pr, pl:ww - pr, :]
        x = shortcut + self.drop_path(x.reshape(b, h * w, c))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class SwinMLPSR(NoKernels, nn.Module):
    """Swin-MLP SR; forward maps NHWC LR (B, H, W, C) to HR."""

    def __init__(self, in_chans: int = 1, embed_dim: int = 60,
                 depths: Sequence[int] = (4, 4, 4),
                 num_heads: Sequence[int] = (4, 4, 4), window_size: int = 8,
                 mlp_ratio: float = 2.0, upscale: int = 4,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        self._no_kernels(dtype, train_resolution)
        self.window_size, self.upscale = int(window_size), int(upscale)
        self.depths = tuple(depths)
        self.conv_first = Conv(in_chans, embed_dim, 3)
        total, k = sum(depths), 0
        for g, depth in enumerate(depths):
            for i in range(depth):
                self.add_module(f"group_{g}_block_{i}", SwinMLPBlock(
                    embed_dim, num_heads[g], window_size,
                    0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                    drop_rate, drop_path_rate * k / max(total - 1, 1)))
                k += 1
            self.add_module(f"group_{g}_conv", Conv(embed_dim, embed_dim, 3))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3)
        self.tail_up = UpSampler(self.upscale, embed_dim)
        self.tail_conv = Conv(embed_dim, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype; ``sr_scale`` is not read (a
        fixed scale)."""
        x = x.to(self.dtype)
        x, (h0, w0) = pad_to_window_multiple(x, self.window_size)
        x = self.conv_first(x)
        tokens, x_size = to_tokens(x)
        for g, depth in enumerate(self.depths):
            group_in = tokens
            for i in range(depth):
                tokens = getattr(self, f"group_{g}_block_{i}")(tokens, x_size)
            img = getattr(self, f"group_{g}_conv")(to_image(tokens, x_size))
            tokens = to_tokens(img)[0] + group_in
        y = self.conv_after_body(to_image(self.norm(tokens), x_size)) + x
        out = self.tail_conv(self.tail_up(y))
        s = self.upscale
        return out[:, : h0 * s, : w0 * s, :]


def make_swinmlp(paras, mean=None, std=None,
                 dtype=torch.float32) -> SwinMLPSR:
    """The JAX package's ``make_swinmlp``: ``swinmlp_embed_dim`` (60),
    ``swinmlp_depths`` ((4, 4, 4)), ``swinmlp_num_heads`` ((4, 4, 4)),
    ``swinmlp_window_size`` (8), ``swinmlp_mlp_ratio`` (2.0),
    ``swin_drop_rate`` and ``swin_drop_path_rate``; ``mean`` / ``std`` are
    not used. No kernel route."""
    return SwinMLPSR(
        in_chans=paras.input_channel,
        embed_dim=int(paras.get("swinmlp_embed_dim", 60)),
        depths=tuple(paras.get("swinmlp_depths", (4, 4, 4))),
        num_heads=tuple(paras.get("swinmlp_num_heads", (4, 4, 4))),
        window_size=int(paras.get("swinmlp_window_size", 8)),
        mlp_ratio=float(paras.get("swinmlp_mlp_ratio", 2.0)),
        upscale=int(paras.sr_scale),
        drop_rate=float(paras.get("swin_drop_rate", 0.0) or 0.0),
        drop_path_rate=float(paras.get("swin_drop_path_rate", 0.0) or 0.0),
        dtype=dtype,
        train_resolution=(paras.patch_size,) * 2,
    ).eval()
