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
``dtype=bfloat16`` (``nn.layers``).

Those are the serving routes, taken in eval mode; they have no gradient
and raise when reached with autograd recording. In training mode
(``module.train()``) every block runs the plain path with dropout and
stochastic depth, differentiated by autograd, unless a bf16 training
route was set by ``models.routes.set_train_mode`` (by the JAX package's
admission rules, :meth:`BasicLayer.train_route`): a
:class:`BasicLayer`'s ``use_pair_train`` runs each pair of blocks as one
differentiable ``kernels.pair_train`` call, a block's ``use_block_train``
runs the block as one ``kernels.block_train`` call; their CUDA forward
and backward take the place of autograd's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from rdst_tpu_torch.nn.layers import (BF16, Dropout, DropPath, LayerNorm,
                                      Linear, Mlp)


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


def refuse_grad(route: str, x: torch.Tensor, module: nn.Module) -> None:
    """A serving route has no gradient: raise when autograd is recording
    for its input or parameters, instead of returning a detached
    output."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in module.parameters())):
        raise RuntimeError(
            f"{route} is a serving kernel without a gradient: run it under "
            "torch.no_grad()/inference_mode(), or put the model in "
            "training mode (model.train()) for the training route")


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


# The cached index and mask tensors are made outside inference mode even
# when the first caller serves under torch.inference_mode(): a training
# step in the same process saves them for its backward.
@functools.lru_cache(maxsize=64)
def _index_tensor(ws: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(relative_position_index(ws, ws).reshape(-1),
                               device=device)


@functools.lru_cache(maxsize=256)
def _mask_tensor(h: int, w: int, ws: int, shift: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    mask = shift_attention_mask(h, w, ws, shift)
    with torch.inference_mode(False):
        return None if mask is None else torch.as_tensor(mask, device=device)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias on (B*nW, N, C) tokens."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        # kernels.logit_audit: when set, the running max attention logit
        # (after scale, bias and mask) is kept in logit_max
        self.audit = False
        self.logit_max: Optional[torch.Tensor] = None
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
        self._audit(attn)
        attn = self.attn_drop(torch.softmax(attn, dim=-1))
        y = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj_drop(self.proj(y))

    def _audit(self, attn):
        if self.audit:
            m = attn.detach().amax().float()
            self.logit_max = (m if self.logit_max is None
                              else torch.maximum(self.logit_max, m))

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
        self._audit(attn)
        e = torch.exp((attn - attn.amax(dim=-1, keepdim=True)).float()
                      ).to(BF16)
        den = e.float().sum(dim=-1, keepdim=True).to(BF16)
        p = self.attn_drop((e.float() / den.float()).to(BF16))
        y = (p.float() @ v.float()).to(BF16).transpose(1, 2).reshape(b_, n, c)
        return self.proj_drop(self.proj(y))


class SwinTransformerBlock(nn.Module):
    """Pre-LN block: (shifted) W-MSA + MLP, both residual. Token input
    (B, L, C) with a static x_size."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.qk_scale = qk_scale
        self.build_resolution = build_resolution
        self.layer_norm = layer_norm
        self.use_kernel = False  # see set_block_kernels
        self.use_block_train = False  # see models.routes.set_train_mode
        self.softmax = ""  # bf16 kernels' softmax variant, set with the mode
        self.quant = frozenset()  # int8 groups of the fast kernel route
        self.generator: Optional[torch.Generator] = None  # factor columns
        # the table's window is decided from the build resolution, as the
        # reference's constructor does; the runtime window must match it
        ws = (min(window_size, *build_resolution) if build_resolution
              else window_size)
        self.norm1 = LayerNorm(dim) if layer_norm else nn.Identity()
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias, qk_scale,
                                    attn_drop, drop)
        self.norm2 = LayerNorm(dim) if layer_norm else nn.Identity()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        ws, shift = self.resolved_window(x_size)
        if ws != self.attn.window_size:
            raise ValueError(
                f"input {h}x{w} resolves to window {ws}, but the block was "
                f"built for window {self.attn.window_size}")
        if self.use_kernel and not self.training:
            return self._fused_block(x, (h, w), ws, shift)
        if self.use_block_train and self.training:
            return self._train_block(x, (h, w), ws, shift)

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
        x = shortcut + self.drop_path(x.reshape(b, h * w, c))
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def resolved_window(self, x_size: Tuple[int, int]) -> Tuple[int, int]:
        """(window, shift) this block runs at on ``x_size``: decided from
        the build resolution, as the reference's constructor does (a
        build resolution of one window means no shift at all)."""
        h, w = x_size
        return resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                self.window_size, self.shift_size)

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
            # contiguous: with one window the sum keeps rel's permuted
            # strides
            bias = (rel[:, None] + mask[None]).reshape(-1, n, n).contiguous()
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
        h, w = x_size
        b, l, c = x.shape
        if not self.layer_norm or self.qk_scale is not None or h % ws or w % ws:
            raise ValueError(
                "the fused block kernel takes LayerNorm blocks with the "
                f"default q scale on whole windows; got layer_norm="
                f"{self.layer_norm}, qk_scale={self.qk_scale}, {h}x{w} with "
                f"window {ws} (build with pallas_kernels='off' for the "
                "plain path)")
        refuse_grad("fused_swin_block", x, self)
        xi = x.reshape(b, h, w, c)
        if shift > 0:
            xi = torch.roll(xi, (-shift, -shift), dims=(1, 2))
        x_windows = window_partition(xi, ws).reshape(-1, ws * ws, c)
        nw = (h // ws) * (w // ws)
        if x.dtype == BF16:
            from rdst_tpu_torch.kernels.swin_block import (plan_fast_block,
                                                           run_fast_block)

            plan = kernel_plan(self, (x_size, ws, shift, x.device,
                                      self.quant),
                               lambda: plan_fast_block(
                                   *self.fast_kernel_inputs(x_size, ws,
                                                            shift),
                                   num_heads=self.num_heads,
                                   quant=self.quant))
            y = run_fast_block(x_windows.contiguous(), plan,
                               num_heads=self.num_heads,
                               windows_per_image=nw, softmax=self.softmax)
        else:
            from rdst_tpu_torch.kernels.swin_block import (plan_f32_block,
                                                           run_f32_block)

            plan = kernel_plan(self, (x_size, ws, shift, x.device),
                               lambda: plan_f32_block(
                                   *self.kernel_inputs(x_size, ws, shift),
                                   num_heads=self.num_heads))
            y = run_f32_block(x_windows.contiguous(), plan,
                              num_heads=self.num_heads, windows_per_image=nw)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        return y.reshape(b, l, c)

    def dp_factor_cols(self, b: int, rows_per_image: int):
        """(B*nW*N, 2) float32 stochastic-depth factor columns [attn,
        mlp] of this block (``_block_dp_cols``): two independent
        per-sample draws, kept with probability 1 - rate and scaled by
        1 / keep; None at rate 0."""
        rate = self.drop_path.rate
        if rate == 0.0:
            return None
        dev = self.attn.qkv.weight.device
        keep = 1.0 - rate
        cols = [torch.where(torch.rand(b, generator=self.generator,
                                       device=dev) < keep, 1.0 / keep, 0.0)
                for _ in range(2)]
        return torch.stack(cols, -1).repeat_interleave(rows_per_image, 0)

    def _train_block(self, x, x_size, ws: int, shift: int):
        """The single-block training route: the block through
        ``kernels.block_train.fused_swin_block_train`` (raw parameters
        folded in plain torch, so autograd reaches them); roll, partition,
        reverse in plain torch."""
        from rdst_tpu_torch.kernels.block_train import fused_swin_block_train

        h, w = x_size
        b, l, c = x.shape
        if x.dtype != BF16 or h % ws or w % ws:
            raise ValueError(
                f"the block-train kernel takes bf16 tokens on whole "
                f"windows; got {x.dtype}, {h}x{w} with window {ws}")
        xi = x.reshape(b, h, w, c)
        if shift > 0:
            xi = torch.roll(xi, (-shift, -shift), dims=(1, 2))
        xw = window_partition(xi, ws).reshape(-1, ws * ws, c)
        nw = (h // ws) * (w // ws)
        params, bias = self.fast_kernel_inputs(x_size, ws, shift)
        y = fused_swin_block_train(
            xw.contiguous(), params, bias,
            self.dp_factor_cols(b, nw * ws * ws), num_heads=self.num_heads,
            windows_per_image=nw, softmax=self.softmax)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        return y.reshape(b, l, c)

    def fast_unsupported(self) -> Optional[str]:
        """Why the bf16 fast block kernel cannot run this block at its
        built window (None when it can): up to ``FAST_MAX_C`` channels;
        checked when the model is built."""
        from rdst_tpu_torch.kernels.swin_block import (FAST_MAX_C,
                                                       fast_kernel_supports)

        if not self.layer_norm or self.qk_scale is not None:
            return "the block has no LayerNorm or a custom q scale"
        n = self.attn.window_size ** 2
        hidden = self.mlp.fc1.out_features
        if not fast_kernel_supports(n, self.dim, self.num_heads, hidden,
                                    max_c=FAST_MAX_C):
            return (f"N={n}, C={self.dim}, {self.num_heads} heads, hidden "
                    f"{hidden} exceed what the CUDA kernels take")
        return None

    def f32_unsupported(self) -> Optional[str]:
        """Why the f32 block kernel cannot run this block at its built
        window (None when it can); checked when the model is built."""
        from rdst_tpu_torch.kernels.swin_block import (F32_MAX_C,
                                                       f32_kernel_supports)

        if not self.layer_norm or self.qk_scale is not None:
            return "the block has no LayerNorm or a custom q scale"
        n = self.attn.window_size ** 2
        hidden = self.mlp.fc1.out_features
        if not f32_kernel_supports(n, self.dim, self.num_heads, hidden):
            return (f"N={n}, C={self.dim}, {self.num_heads} heads, hidden "
                    f"{hidden} exceed what the f32 kernel takes: N | 64 "
                    f"with N % 8 == 0, even C <= {F32_MAX_C}, head dim "
                    "<= 32")
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
                 layer_norm: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Tuple[float, ...] = ()):
        super().__init__()
        self.drop_path = tuple(float(r) for r in drop_path) or (0.0,) * depth
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(
                dim, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                build_resolution=build_resolution, layer_norm=layer_norm,
                drop=drop, attn_drop=attn_drop, drop_path=self.drop_path[i])
            for i in range(depth)])
        self.window_size = window_size
        self.build_resolution = build_resolution
        self.drop, self.attn_drop = float(drop), float(attn_drop)
        self.use_pair = False  # see models.routes.set_kernel_mode
        self.quant = frozenset()  # int8 groups of the pair kernel route
        self.use_pair_train = False  # see models.routes.set_train_mode
        self.softmax = ""
        self.generator: Optional[torch.Generator] = None  # factor columns

    def pair_unsupported(self, quant=frozenset()) -> Optional[str]:
        """Why the pair kernel cannot run this layer's blocks with the
        int8 groups ``quant`` (None when it can): what ``BasicLayer``'s
        ``pair_eligible`` asks in the JAX package, and what the stage
        design of the blocks' width takes; checked when the model is
        built."""
        from rdst_tpu_torch.kernels.swin_pair import pair_kernel_supports

        if not self.blocks or len(self.blocks) % 2:
            return f"depth {len(self.blocks)} is not a whole number of pairs"
        blk = self.blocks[0]
        if not blk.layer_norm or blk.qk_scale is not None:
            return "the block has no LayerNorm or a custom q scale"
        n = blk.attn.window_size ** 2
        hidden = blk.mlp.fc1.out_features
        if not pair_kernel_supports(n, blk.dim, blk.num_heads, hidden,
                                    "qkv" in quant):
            return (f"N={n}, C={blk.dim}, {blk.num_heads} heads, hidden "
                    f"{hidden} exceed what the pair's stage kernels take")
        return None

    def train_route(self, mode: str, x_size: Tuple[int, int],
                    softmax: str = "") -> str:
        """The bf16 training route of this layer for ``pallas_train=mode``
        at training patches of ``x_size``, as the JAX package chooses it
        (``BasicLayer.__call__`` and ``SwinTransformerBlock.__call__``):
        'pair' when the mode is 'pair', the pair's structure holds and
        ``fused_pair_train_fits`` admits it; else 'block' when
        ``fused_block_train_fits`` does. The JAX package's admission
        rules decide, not what the CUDA kernels could take; a layer the
        rule admits but the CUDA kernels do not take, and a layer neither
        route takes, raise and name ``pallas_train='off'``."""
        from rdst_tpu_torch.kernels.block_train import (
            block_train_kernel_supports, fused_block_train_fits,
            fused_pair_train_fits)
        from rdst_tpu_torch.kernels.pair_train import (
            pair_train_kernel_supports)

        h, w = x_size
        ws, _ = resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                 self.window_size, self.window_size // 2)
        blk = self.blocks[0]
        n, c, nh = ws * ws, blk.dim, blk.num_heads
        hidden = blk.mlp.fc1.out_features
        nw = (h // ws) * (w // ws)
        off = "; build with pallas_train='off'"
        if not blk.layer_norm or blk.qk_scale is not None:
            raise ValueError("the train kernels take LayerNorm blocks with "
                             "the default q scale" + off)
        if self.drop or self.attn_drop:
            raise ValueError(f"dropout rates {self.drop}/{self.attn_drop} "
                             "(the train kernels apply stochastic depth "
                             "only)" + off)
        if h % ws or w % ws:
            raise ValueError(f"training patches {h}x{w} are not whole "
                             f"windows of {ws}" + off)
        geom = (f"N={n}, C={c}, {nh} heads, hidden {hidden}, {nw} windows "
                "per image")
        if (mode == "pair" and len(self.blocks) % 2 == 0
                and fused_pair_train_fits(nw, n, c, nh, hidden, 2, softmax)):
            if not pair_train_kernel_supports(n, c, nh, hidden):
                raise ValueError(f"the train-pair CUDA kernels do not take "
                                 f"{geom}" + off)
            return "pair"
        if not fused_block_train_fits(nw, n, c, nh, hidden, 2, softmax):
            raise ValueError(f"no train kernel admits {geom}" + off)
        if not block_train_kernel_supports(n, c, nh, hidden):
            raise ValueError(f"the block-train CUDA kernels do not take "
                             f"{geom}" + off)
        return "block"

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        if self.training and self.use_pair_train:
            return self._train_pairs(x, x_size)
        if self.use_pair and not self.training:
            return self._fused_pairs(x, x_size)
        for block in self.blocks:
            x = block(x, x_size)
        return x

    def dp_factor_cols(self, b: int, rows_per_image: int, i: int):
        """(B*nW*N, 4) float32 stochastic-depth factor columns [attn_a,
        mlp_a, attn_b, mlp_b] for blocks i, i+1 (``_dp_factor_cols``):
        four independent per-sample draws, kept with probability 1 -
        rate and scaled by 1 / keep; None when both rates are 0."""
        dpa, dpb = self.drop_path[i], self.drop_path[i + 1]
        if dpa == 0.0 and dpb == 0.0:
            return None
        dev = self.blocks[0].attn.qkv.weight.device
        cols = []
        for r in (dpa, dpa, dpb, dpb):
            if r == 0.0:
                cols.append(torch.ones(b, device=dev))
            else:
                keep = 1.0 - r
                u = torch.rand(b, generator=self.generator, device=dev)
                cols.append(torch.where(u < keep, 1.0 / keep, 0.0))
        return torch.stack(cols, -1).repeat_interleave(rows_per_image, 0)

    def _window_geometry(self, x, x_size, kernel: str):
        h, w = x_size
        ws, shift = resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                     self.window_size, self.window_size // 2)
        if x.dtype != BF16 or h % ws or w % ws:
            raise ValueError(
                f"the {kernel} kernel takes bf16 tokens on whole windows; "
                f"got {x.dtype}, {h}x{w} with window {ws}")
        if ws != self.blocks[0].attn.window_size:
            raise ValueError(
                f"input {h}x{w} resolves to window {ws}, but the block "
                f"was built for window {self.blocks[0].attn.window_size}")
        return ws, shift

    def _train_pairs(self, x, x_size):
        """The training route: each pair of blocks through
        ``kernels.pair_train.fused_swin_pair_train`` (raw parameters
        folded in plain torch, so autograd reaches them); entry
        partition and exit reverse + roll in plain torch."""
        from rdst_tpu_torch.kernels.pair_train import fused_swin_pair_train

        h, w = x_size
        b, l, c = x.shape
        ws, shift = self._window_geometry(x, x_size, "train-pair")
        nh = self.blocks[0].num_heads
        n = ws * ws
        rows = (h // ws) * (w // ws) * n
        for i in range(0, len(self.blocks), 2):
            pa, ba = self.blocks[i].fast_kernel_inputs(x_size, ws, 0)
            pb, bb = self.blocks[i + 1].fast_kernel_inputs(x_size, ws, shift)
            xw = window_partition(x.reshape(b, h, w, c), ws)
            y = fused_swin_pair_train(
                xw.reshape(-1, n, c).contiguous(), pa, ba, pb, bb,
                self.dp_factor_cols(b, rows, i), num_heads=nh,
                x_size=x_size, window_size=ws, shift=shift,
                softmax=self.softmax)
            y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
            if shift > 0:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            x = y.reshape(b, l, c)
        return x

    def _fused_pairs(self, x, x_size):
        from rdst_tpu_torch.kernels.swin_pair import (plan_pair_block,
                                                      run_swin_pair)

        h, w = x_size
        b, l, c = x.shape
        refuse_grad("fused_swin_pair", x, self)
        ws, shift = self._window_geometry(x, x_size, "pair")
        nh = self.blocks[0].num_heads

        def build():
            return [(plan_pair_block(*a.fast_kernel_inputs(x_size, ws, 0),
                                     num_heads=nh, quant=self.quant),
                     plan_pair_block(*bb.fast_kernel_inputs(x_size, ws,
                                                            shift),
                                     num_heads=nh, quant=self.quant))
                    for a, bb in zip(self.blocks[0::2], self.blocks[1::2])]

        plans = kernel_plan(self, ("pair", x_size, ws, shift, x.device,
                                   self.quant), build)
        for plan_a, plan_b in plans:
            xw = window_partition(x.reshape(b, h, w, c), ws)
            y = run_swin_pair(xw.reshape(-1, ws * ws, c).contiguous(),
                              plan_a, plan_b,
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


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat + LayerNorm + bias-free linear reduction to
    2C (``rdst_tpu/nn/swin.py::PatchMerging``, the Swin discriminator's
    downsampling): (B, H*W, C) tokens -> (B, H*W/4, 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x))
