"""Meta-Upscale: arbitrary-scale upsampling (Meta-SR, CVPR'19), the
counterpart of ``rdst_tpu/models/meta_upscale.py``.

* ``Pos2Weight``, a small MLP, predicts a 3x3 x C -> outC filter for each
  fractional sub-position from (1/r, dh, dw);
* ``meta_upscale_plan`` resolves the index math on the host, in numpy, as
  the JAX package does at trace time: the periodic tile of distinct
  offsets, each output-grid cell's tile entry, and the valid cells;
* ``MetaUpSampler`` gathers each cell's filter, applies it to the 3x3
  neighbourhood of its LR pixel (patches in ``F.unfold``'s layout, C
  slowest: ``c*9 + di*3 + dj``, the layout ``fc2``'s output is read in)
  and keeps the valid cells.

The JAX package computes all of this in XLA, outside any Pallas kernel;
here it is plain PyTorch (``F.unfold``, an index gather, ``torch.einsum``).
Output sizes are ``int(scale * in_size)`` in floating point, as there.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.device import device_table
from rdst_tpu_torch.nn.layers import BF16, Linear


def _axis_offsets(in_size: int, scale: float, scale_int: int):
    """The reference's per-axis offset/mask construction
    (input_matrix_wpn_new, meta_upscale.py:102-147)."""
    out_size = int(scale * in_size)
    offset = np.ones((in_size, scale_int))
    mask = np.zeros((in_size, scale_int))
    project = np.arange(out_size) / scale
    int_project = np.floor(project).astype(int)
    frac = project - int_project
    flag, number = 0, 0
    for i in range(out_size):
        if int_project[i] == number:
            offset[int_project[i], flag] = frac[i]
            mask[int_project[i], flag] = 1
            flag += 1
        else:
            offset[int_project[i], 0] = frac[i]
            mask[int_project[i], 0] = 1
            number += 1
            flag = 1
    return offset.reshape(-1), mask.reshape(-1)


@functools.lru_cache(maxsize=128)
def meta_upscale_plan(in_h: int, in_w: int, scale: float):
    """Static plan: (pos_small (P,3), tile_idx (outHg,outWg), valid_idx)."""
    scale_int = int(math.ceil(scale))
    h_off, h_mask = _axis_offsets(in_h, scale, scale_int)
    w_off, w_mask = _axis_offsets(in_w, scale, scale_int)

    pos = np.stack(np.meshgrid(h_off, w_off, indexing="ij"), axis=-1)
    mask = (h_mask[:, None] + w_mask[None, :]) == 2

    # periods of the unique offset tile (meta_upscale.py:169-181)
    i = 1
    while i < pos.shape[0] and pos[i, 0, 0] >= 1e-6:
        i += 1
    j = 1
    while j < pos.shape[1] and pos[0, j, 1] >= 1e-6:
        j += 1
    pos_small = pos[:i, :j].reshape(-1, 2)
    pos_small = np.concatenate(
        [np.full((pos_small.shape[0], 1), 1.0 / scale), pos_small], axis=1
    ).astype(np.float32)

    out_hg, out_wg = scale_int * in_h, scale_int * in_w
    rows = np.arange(out_hg) % i
    cols = np.arange(out_wg) % j
    tile_idx = rows[:, None] * j + cols[None, :]  # (outHg, outWg) -> P

    valid_idx = np.where(mask.reshape(-1))[0].astype(np.int32)
    return pos_small, tile_idx.astype(np.int32), valid_idx


@device_table(64)
def _device_plan(in_h: int, in_w: int, scale: float, device: torch.device):
    """The plan's arrays on ``device`` (a bounded cache: a training run
    sees one geometry a scale, so its steps copy nothing to the card)."""
    pos_small, tile_idx, valid_idx = meta_upscale_plan(in_h, in_w, scale)
    return (torch.from_numpy(pos_small).to(device),
            torch.from_numpy(tile_idx).long().to(device),
            torch.from_numpy(valid_idx).long().to(device))


def scale_value(sr_scale) -> float:
    """The scale a scale-free model is called at, as a float. None raises:
    such a model has no nominal scale to fall back on."""
    if sr_scale is None:
        raise ValueError("a scale-free model needs the scale it is called "
                         "at (sr_scale)")
    return float(sr_scale)


class Pos2Weight(nn.Module):
    """(1/r, dh, dw) -> 3x3 * in_c * out_c filter entries
    (meta_upscale.py:6-20): ``fc1`` (3 -> 256), ReLU, ``fc2``."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int = 3):
        super().__init__()
        self.fc1 = Linear(3, 256)
        self.fc2 = Linear(256, kernel_size ** 2 * in_c * out_c)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(pos)))


class MetaUpSampler(nn.Module):
    """Arbitrary-scale upsampling head (meta_upscale.py:23-100) on NHWC
    features of ``in_c`` channels: ``forward(x, sr_scale)`` ->
    (N, int(s*H), int(s*W), out_c). In bfloat16 the filters and the
    product are rounded to bf16 as flax's ``dtype=bfloat16`` modules
    round them (f32 sums)."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int = 3):
        super().__init__()
        if kernel_size != 3:
            raise NotImplementedError(
                f"meta_sr_kernel_size {kernel_size}: the upsampler takes "
                "3x3 neighbourhoods, as in the JAX package")
        self.in_c, self.out_c = int(in_c), int(out_c)
        self.P2W = Pos2Weight(in_c, out_c, kernel_size)

    def forward(self, x: torch.Tensor, sr_scale) -> torch.Tensor:
        scale = scale_value(sr_scale)
        n, in_h, in_w, c = x.shape
        if c != self.in_c:
            raise ValueError(f"expected {self.in_c} channels, got {c}")
        s = int(math.ceil(scale))
        out_h, out_w = int(scale * in_h), int(scale * in_w)
        pos, tile_idx, valid_idx = _device_plan(in_h, in_w, scale, x.device)

        weights = self.P2W(pos.to(x.dtype))  # (P, 9*C*outC)
        weights = weights.reshape(pos.shape[0], c * 9, self.out_c)
        # (N, 9C, H*W) with index c*9 + di*3 + dj -> (N, H, W, 9C)
        patches = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)
        patches = patches.transpose(1, 2).reshape(n, in_h, in_w, c * 9)
        w_tiled = weights[tile_idx].reshape(in_h, s, in_w, s, c * 9,
                                            self.out_c)
        if x.dtype == BF16:  # bf16 operands, f32 sums, the result rounded
            out = torch.einsum("nhwk,hawbko->nhawbo", patches.float(),
                               w_tiled.float()).to(BF16)
        else:
            out = torch.einsum("nhwk,hawbko->nhawbo", patches, w_tiled)
        flat = out.reshape(n, s * in_h * s * in_w, self.out_c)
        return flat[:, valid_idx].reshape(n, out_h, out_w, self.out_c)
