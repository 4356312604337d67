"""Swin transformer core (counterpart of ``rdst_tpu/nn/swin.py``).

Window partition/reverse are reshapes on NHWC; the relative-position
index and the shifted-window mask are built with numpy from static
shapes, as in the JAX package, and cached per device.

A :class:`SwinTransformerBlock` runs either the plain path (LN ->
roll -> partition -> :class:`WindowAttention` -> reverse -> MLP) or, when
its ``use_kernel`` is set (:func:`set_block_kernels`, which the model
builder calls once with the config's kernel mode), the fused block
``kernels.swin_block.fused_swin_block`` on window-layout tokens with
roll, partition and reverse outside it: the f32 precise kernel on
float32 tokens, the fast kernel on bfloat16 tokens. A :class:`BasicLayer`
whose ``use_pair`` is set runs each pair of blocks through
``kernels.swin_pair`` instead (bf16 only). A block the kernel does not
take raises in kernel mode instead of taking the plain path. On bfloat16
tokens the plain path computes as the JAX package's flax modules do at
``dtype=bfloat16`` (``nn.layers``). The port serves inference only: no
dropout or stochastic depth.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from rdst_tpu_torch.nn.layers import BF16, LayerNorm, Linear, Mlp


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws, ws, C)."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """(B*nW, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=64)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position index (wh*ww, wh*ww) into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=256)
def shift_attention_mask(h: int, w: int, window_size: int,
                         shift: int) -> Optional[np.ndarray]:
    """SW-MSA mask (nW, N, N) with 0 / -100 entries; None when shift == 0."""
    if shift == 0:
        return None
    img_mask = np.zeros((h, w))
    slices = (slice(0, -window_size), slice(-window_size, -shift),
              slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[hs, ws_] = cnt
            cnt += 1
    m = img_mask.reshape(h // window_size, window_size,
                         w // window_size, window_size)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def resolve_ws_shift(decide_res: Tuple[int, int], h: int, w: int,
                     ws: int, shift: int) -> Tuple[int, int]:
    """The reference's constructor-time clamp: a window larger than the
    (build) input means no partitioning and no shift; then never exceed
    the runtime extent."""
    if min(decide_res) <= ws:
        shift = 0
        ws = min(decide_res)
    ws = min(ws, h, w)
    if shift >= ws:
        shift = 0
    return ws, shift


def kernel_plan(module: nn.Module, key, build):
    """A fused kernel's prepared operands, kept on ``module`` while its
    parameters (by storage and in-place version) and ``key`` stay the
    same; ``build()`` makes them anew otherwise. Parameters created under
    ``torch.inference_mode`` have no version counter; they are keyed by
    storage alone."""
    key = (key, tuple((p.data_ptr(), -1 if p.is_inference() else p._version)
                      for p in module.parameters()))
    cached = getattr(module, "_kernel_plan", None)
    if cached is None or cached[0] != key:
        cached = (key, build())
        module._kernel_plan = cached
    return cached[1]


@functools.lru_cache(maxsize=64)
def _index_tensor(ws: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(relative_position_index(ws, ws).reshape(-1),
                           device=device)


@functools.lru_cache(maxsize=256)
def _mask_tensor(h: int, w: int, ws: int, shift: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    mask = shift_attention_mask(h, w, ws, shift)
    return None if mask is None else torch.as_tensor(mask, device=device)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias on (B*nW, N, C) tokens."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def rel_bias(self) -> torch.Tensor:
        """(nH, N, N) relative-position bias gathered from the table."""
        n = self.window_size ** 2
        idx = _index_tensor(self.window_size,
                            self.relative_position_bias_table.device)
        return self.relative_position_bias_table[idx].reshape(
            n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dtype == BF16:
            return self._forward_bf16(x, mask)
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * self.scale) @ k.transpose(-2, -1)  # (B_, nH, N, N)
        attn = attn + self.rel_bias()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, nh, n, n)
                    + mask[None, :, None]).reshape(-1, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(y)

    def _forward_bf16(self, x, mask):
        """The JAX package's bf16 XLA attention: every op's output rounded
        to bf16 (q * scale, the scores, the biases added, each softmax
        step, the attention-weighted values); products and sums in f32."""
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = ((q * self.scale).float() @ k.float().transpose(-2, -1)
                ).to(BF16)
        attn = attn + self.rel_bias().to(BF16)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, nh, n, n)
                    + mask.to(BF16)[None, :, None]).reshape(-1, nh, n, n)
        e = torch.exp((attn - attn.amax(dim=-1, keepdim=True)).float()
                      ).to(BF16)
        den = e.float().sum(dim=-1, keepdim=True).to(BF16)
        p = (e.float() / den.float()).to(BF16)
        y = (p.float() @ v.float()).to(BF16).transpose(1, 2).reshape(b_, n, c)
        return self.proj(y)


class SwinTransformerBlock(nn.Module):
    """Pre-LN block: (shifted) W-MSA + MLP, both residual. Token input
    (B, L, C) with a static x_size."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.qk_scale = qk_scale
        self.build_resolution = build_resolution
        self.layer_norm = layer_norm
        self.use_kernel = False  # see set_block_kernels
        self.softmax = ""  # bf16 kernels' softmax variant, set with the mode
        # the table's window is decided from the build resolution, as the
        # reference's constructor does; the runtime window must match it
        ws = (min(window_size, *build_resolution) if build_resolution
              else window_size)
        self.norm1 = LayerNorm(dim) if layer_norm else nn.Identity()
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias, qk_scale)
        self.norm2 = LayerNorm(dim) if layer_norm else nn.Identity()
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        ws, shift = resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                     self.window_size, self.shift_size)
        if ws != self.attn.window_size:
            raise ValueError(
                f"input {h}x{w} resolves to window {ws}, but the block was "
                f"built for window {self.attn.window_size}")
        if self.use_kernel:
            return self._fused_block(x, (h, w), ws, shift)

        b, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        x_windows = window_partition(x, ws).reshape(-1, ws * ws, c)
        attn_windows = self.attn(x_windows, _mask_tensor(h, w, ws, shift,
                                                         x.device))
        x = window_reverse(attn_windows.reshape(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))

    def kernel_inputs(self, x_size: Tuple[int, int], ws: int, shift: int):
        """(params 12-tuple in the kernel's (in, out) layout, bias).

        bias: (nH*nW, N, N) rel-pos + shift mask, head-major, when
        shifted; else the (nH, N, N) rel-pos shared by every window."""
        h, w = x_size
        n = ws * ws
        a, m = self.attn, self.mlp
        rel = a.rel_bias()
        mask = _mask_tensor(h, w, ws, shift, rel.device)
        if mask is not None:
            bias = (rel[:, None] + mask[None]).reshape(-1, n, n)
        else:
            bias = rel.contiguous()
        params = (a.qkv.weight.t().contiguous(),
                  None if a.qkv.bias is None else a.qkv.bias,
                  a.proj.weight.t().contiguous(), a.proj.bias,
                  self.norm1.weight, self.norm1.bias,
                  self.norm2.weight, self.norm2.bias,
                  m.fc1.weight.t().contiguous(), m.fc1.bias,
                  m.fc2.weight.t().contiguous(), m.fc2.bias)
        return params, bias

    def _fused_block(self, x, x_size, ws: int, shift: int):
        from rdst_tpu_torch.kernels.swin_block import fused_swin_block

        h, w = x_size
        b, l, c = x.shape
        if not self.layer_norm or self.qk_scale is not None or h % ws or w % ws:
            raise ValueError(
                "the fused block kernel takes LayerNorm blocks with the "
                f"default q scale on whole windows; got layer_norm="
                f"{self.layer_norm}, qk_scale={self.qk_scale}, {h}x{w} with "
                f"window {ws} (build with pallas_kernels='off' for the "
                "plain path)")
        xi = x.reshape(b, h, w, c)
        if shift > 0:
            xi = torch.roll(xi, (-shift, -shift), dims=(1, 2))
        x_windows = window_partition(xi, ws).reshape(-1, ws * ws, c)
        nw = (h // ws) * (w // ws)
        if x.dtype == BF16:
            from rdst_tpu_torch.kernels.swin_block import (plan_fast_block,
                                                           run_fast_block)

            plan = kernel_plan(self, (x_size, ws, shift, x.device),
                               lambda: plan_fast_block(
                                   *self.fast_kernel_inputs(x_size, ws,
                                                            shift),
                                   num_heads=self.num_heads))
            y = run_fast_block(x_windows.contiguous(), plan,
                               num_heads=self.num_heads,
                               windows_per_image=nw, softmax=self.softmax)
        else:
            params, bias = self.kernel_inputs(x_size, ws, shift)
            y = fused_swin_block(x_windows.contiguous(), *params, bias,
                                 num_heads=self.num_heads,
                                 windows_per_image=nw)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        return y.reshape(b, l, c)

    def fast_unsupported(self) -> Optional[str]:
        """Why the bf16 fast kernels cannot run this block at its built
        window (None when they can); checked when the model is built."""
        from rdst_tpu_torch.kernels.swin_block import fast_kernel_supports

        if not self.layer_norm or self.qk_scale is not None:
            return "the block has no LayerNorm or a custom q scale"
        n = self.attn.window_size ** 2
        hidden = self.mlp.fc1.out_features
        if not fast_kernel_supports(n, self.dim, self.num_heads, hidden):
            return (f"N={n}, C={self.dim}, {self.num_heads} heads, hidden "
                    f"{hidden} exceed what the CUDA kernels take")
        return None

    def fast_kernel_inputs(self, x_size: Tuple[int, int], ws: int,
                           shift: int):
        """:meth:`kernel_inputs` as the JAX package hands them to a bf16
        kernel (``_kernel_inputs``/``_fused_block``): the bias rounded to
        bf16 after the mask is added; the weights stay f32 masters (the
        kernel wrappers round them in the JAX order)."""
        params, bias = self.kernel_inputs(x_size, ws, shift)
        return params, bias.to(BF16)


class BasicLayer(nn.Module):
    """Stack of ``depth`` blocks, alternating shift 0 / ws//2. With
    ``use_pair`` set (bf16, mode 'pair'), each pair of blocks runs as one
    ``kernels.swin_pair`` launch."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(
                dim, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                build_resolution=build_resolution, layer_norm=layer_norm)
            for i in range(depth)])
        self.window_size = window_size
        self.build_resolution = build_resolution
        self.use_pair = False  # see models.rdst.set_kernel_mode
        self.softmax = ""

    def pair_unsupported(self) -> Optional[str]:
        """Why the pair kernel cannot run this layer's blocks (None when
        it can): what ``BasicLayer``'s ``pair_eligible`` asks in the JAX
        package, checked when the model is built."""
        if not self.blocks or len(self.blocks) % 2:
            return f"depth {len(self.blocks)} is not a whole number of pairs"
        return self.blocks[0].fast_unsupported()

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        if self.use_pair:
            return self._fused_pairs(x, x_size)
        for block in self.blocks:
            x = block(x, x_size)
        return x

    def _fused_pairs(self, x, x_size):
        from rdst_tpu_torch.kernels.swin_block import plan_fast_block
        from rdst_tpu_torch.kernels.swin_pair import run_swin_pair

        h, w = x_size
        b, l, c = x.shape
        ws, shift = resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                     self.window_size, self.window_size // 2)
        if x.dtype != BF16 or h % ws or w % ws:
            raise ValueError(
                f"the pair kernel takes bf16 tokens on whole windows; got "
                f"{x.dtype}, {h}x{w} with window {ws} (build with "
                "pallas_kernels='swin' or 'off')")
        nh = self.blocks[0].num_heads
        if ws != self.blocks[0].attn.window_size:
            raise ValueError(
                f"input {h}x{w} resolves to window {ws}, but the block "
                f"was built for window {self.blocks[0].attn.window_size}")

        def build():
            return [(plan_fast_block(*a.fast_kernel_inputs(x_size, ws, 0),
                                     num_heads=nh),
                     plan_fast_block(*bb.fast_kernel_inputs(x_size, ws,
                                                            shift),
                                     num_heads=nh))
                    for a, bb in zip(self.blocks[0::2], self.blocks[1::2])]

        plans = kernel_plan(self, ("pair", x_size, ws, shift, x.device),
                            build)
        for plan_a, plan_b in plans:
            xw = window_partition(x.reshape(b, h, w, c), ws)
            y = run_swin_pair(xw.reshape(-1, ws * ws, c), plan_a, plan_b,
                              num_heads=nh, x_size=x_size, window_size=ws,
                              shift=shift, softmax=self.softmax)
            # y is in SHIFTED window layout
            y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
            if shift > 0:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            x = y.reshape(b, l, c)
        return x


def set_block_kernels(module: nn.Module, on: bool) -> int:
    """Route every :class:`SwinTransformerBlock` under ``module`` through
    the fused block kernel (``on``) or the plain path; returns how many
    blocks were set."""
    blocks = [m for m in module.modules()
              if isinstance(m, SwinTransformerBlock)]
    for blk in blocks:
        blk.use_kernel = bool(on)
    return len(blocks)
