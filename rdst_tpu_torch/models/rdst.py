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
(B, L, C) tokens, as in the JAX package.

The model computes in its ``dtype`` (float32, or bfloat16 with float32
parameter masters: the input is rounded to bf16 first, as the JAX
serving path does, and every layer follows ``nn.layers``' policy). Its
kernel routes are decided once, by :func:`set_kernel_mode` when the
model is built: in float32 every kernel mode runs each Swin block on the
f32 block kernel; in bfloat16, 'rdstb' runs each RDSTB as one
``kernels.rdstb_block`` launch, 'pair' each DSTL's block pair as one
``kernels.swin_pair`` launch, and 'swin'/'pack' each block on the fast
block kernel. A block the mode's kernel cannot take raises and names the
mode to choose instead; nothing falls back quietly.

Those routes serve (eval mode, no gradient). A model built here starts
in eval mode; in training mode (``model.train()``) the blocks compute
for autograd: float32 trains on the plain modules, as the JAX package
does; bfloat16 runs each DSTL pair on the differentiable train-pair
kernels (``pallas_train='pair'``, the default) or on the plain bf16
modules (``'off'``), as decided once by :func:`set_train_mode`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rdst_tpu_torch.nn.common import Conv, MeanShift, UpSampler
from rdst_tpu_torch.nn.layers import BF16, Dropout, LayerNorm, Linear
from rdst_tpu_torch.nn.swin import (BasicLayer, kernel_plan, refuse_grad,
                                    resolve_ws_shift, set_block_kernels)


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


def reflect_index(size: int, padded: int) -> torch.Tensor:
    """Source indices of ``jnp.pad(mode='reflect')`` padding an axis of
    ``size`` at its end up to ``padded``: the reflection (edge not
    repeated) goes on past the far edge, period 2(size - 1), so a pad
    longer than the axis is allowed (torch's reflect pad refuses it)."""
    i = torch.arange(padded)
    if size == 1:
        return torch.zeros_like(i)
    j = i % (2 * size - 2)
    return torch.where(j < size, j, 2 * size - 2 - j)


def pad_to_window_multiple(x: torch.Tensor, multiple: int
                           ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Reflect-pad H, W of an NHWC batch up to a window multiple, as
    ``jnp.pad(mode='reflect')`` does; the caller crops the output back."""
    b, h, w, c = x.shape
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph:
        x = x.index_select(1, reflect_index(h, h + ph).to(x.device))
    if pw:
        x = x.index_select(2, reflect_index(w, w + pw).to(x.device))
    return x, (h, w)


def _adapter(in_dim: int, out_dim: int, pre_norm: bool,
             layer_norm: bool) -> nn.Sequential:
    """[LN(in), Linear] when pre_norm, else [Linear, LN(out)]; the
    LayerNorm is an Identity when the model has no norms."""
    if pre_norm:
        return nn.Sequential(LayerNorm(in_dim) if layer_norm else nn.Identity(),
                             Linear(in_dim, out_dim))
    return nn.Sequential(Linear(in_dim, out_dim),
                         LayerNorm(out_dim) if layer_norm else nn.Identity())


class DenseSTLayer(nn.Module):
    """DSTL: Swin pair + dim adapter + dense concat."""

    def __init__(self, input_dim: int, growth_rate: int, depth: int = 2,
                 num_heads: int = 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dense_scale: float = 1.0,
                 dim_modify_mode: str = "tail", pre_norm: bool = False,
                 build_resolution: Optional[Tuple[int, int]] = None,
                 layer_norm: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0):
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
                               build_resolution, layer_norm, drop, attn_drop)
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
                 layer_norm: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(
                f"resi_connection {resi_connection!r}: only '1conv' (every "
                "shipped RDST config) is ported")
        self.residual_scale = residual_scale
        self.input_dim, self.growth_rate = input_dim, growth_rate
        self.num_heads, self.window_size = num_heads, window_size
        self.mlp_ratio, self.pre_norm = mlp_ratio, pre_norm
        self.layer_depth, self.layer_norm = layer_depth, layer_norm
        self.qk_scale, self.dense_scale = qk_scale, dense_scale
        self.dim_modify_mode = dim_modify_mode
        self.build_resolution = build_resolution
        self.use_rdstb = False  # see set_kernel_mode
        self.softmax = ""
        self.body = nn.ModuleList([
            DenseSTLayer(input_dim + i * growth_rate, growth_rate,
                         layer_depth, num_heads, window_size, mlp_ratio,
                         qkv_bias, qk_scale, dense_scale, dim_modify_mode,
                         pre_norm, build_resolution, layer_norm, drop,
                         attn_drop)
            for i in range(int(num_blocks))])
        self.conv = Conv(input_dim + int(num_blocks) * growth_rate,
                         input_dim, 3)

    def _window(self, h: int, w: int) -> Tuple[int, int]:
        return resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                self.window_size, self.window_size // 2)

    def rdstb_unsupported(self) -> Optional[str]:
        """Why the RDSTB kernel cannot run this block (None when it can):
        the structure ``RDSTB._use_fused_rdstb`` asks for in the JAX
        package, and what the CUDA kernel takes at the build resolution.
        Checked when the model is built; the wrapper checks the runtime
        geometry again at every call."""
        from rdst_tpu_torch.kernels.rdstb_block import rdstb_kernel_supports

        nb = len(self.body)
        widths = [self.input_dim + i * self.growth_rate for i in range(nb)]
        if self.layer_depth != 2 or not self.layer_norm:
            return (f"layer_depth {self.layer_depth} / layer_norm "
                    f"{self.layer_norm}: the kernel runs one LayerNorm pair "
                    "per DSTL")
        if (self.dim_modify_mode != "tail" or self.qk_scale is not None
                or self.dense_scale != 1.0 or self.residual_scale != 1.0
                or self.input_dim == self.growth_rate):
            return ("the kernel takes tail adapters, the default q scale "
                    "and unit dense and residual scales")
        if any(c % self.num_heads for c in widths):
            return f"widths {widths} are not multiples of {self.num_heads}"
        h, w = self.build_resolution or (self.window_size,) * 2
        ws, _ = self._window(h, w)
        if not rdstb_kernel_supports(ws * ws, self.input_dim,
                                     self.growth_rate, nb, self.num_heads,
                                     self.mlp_ratio):
            return (f"{nb} DSTLs of C0={self.input_dim} growing by "
                    f"{self.growth_rate} with window {ws} exceed what the "
                    "CUDA kernel takes")
        return None

    def rdstb_inputs(self, x_size: Tuple[int, int], ws: int, shift: int):
        """(dstls, conv_kernel HWIO, conv_bias) in the argument layout of
        the JAX ``fused_rdstb`` (``RDSTB._fused_rdstb``)."""
        dstls = []
        for layer in self.body:
            a, b = layer.body.blocks
            t = layer.tail
            ln, lin = (t[0], t[1]) if self.pre_norm else (t[1], t[0])
            dstls.append({
                "blocks": [a.fast_kernel_inputs(x_size, ws, 0),
                           b.fast_kernel_inputs(x_size, ws, shift)],
                "adapter": (lin.weight.t(), lin.bias, ln.weight, ln.bias)})
        return dstls, self.conv.weight.permute(2, 3, 1, 0), self.conv.bias

    def _fused_rdstb(self, x, x_size):
        from rdst_tpu_torch.kernels.rdstb_block import plan_rdstb, run_rdstb

        refuse_grad("fused_rdstb", x, self)
        h, w = x_size
        ws, shift = self._window(h, w)
        built = self.body[0].body.blocks[0].attn.window_size
        if x.dtype != BF16 or ws != built:
            raise ValueError(
                f"the RDSTB kernel takes bf16 tokens at the built window "
                f"{built}; got {x.dtype}, {h}x{w} resolving to window {ws} "
                "(build with pallas_kernels='off')")
        plan = kernel_plan(
            self, ("rdstb", x_size, ws, shift, x.device),
            lambda: plan_rdstb(*self.rdstb_inputs(x_size, ws, shift),
                               num_heads=self.num_heads,
                               growth=self.growth_rate,
                               adapter_prenorm=self.pre_norm))
        return run_rdstb(x.contiguous(), plan, num_heads=self.num_heads,
                         x_size=x_size, window_size=ws, shift=shift,
                         softmax=self.softmax)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        if self.use_rdstb and not self.training:
            return self._fused_rdstb(x, x_size)
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
                 build_resolution: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        # no drop path rate: the JAX RDSTSR takes swin_drop_path_rate but
        # never hands it to its RDSTBs (rdst_tpu/models/rdst.py:410-428),
        # so stochastic depth stays off in RDST training
        self.train_mode = ""  # plain autograd until set_train_mode
        if dtype not in (torch.float32, BF16):
            raise NotImplementedError(
                f"RDST in {dtype}: the port computes in float32 or bfloat16")
        self.dtype = dtype
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
                  build_resolution, layer_norm, drop_rate, attn_drop)
            for i in range(len(rdb_depths))])
        self.pos_drop = Dropout(drop_rate)
        self.norm = LayerNorm(embed_dim) if layer_norm else None
        self.conv_after_body = (Conv(embed_dim, embed_dim, 3)
                                if feature_last_operation else None)
        self.tail = nn.Sequential(
            UpSampler(self.sr_scale, embed_dim) if self.sr_scale > 1
            else nn.Identity(),
            Conv(embed_dim, in_chans, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype (bf16: the input is rounded
        to bf16 first, as ``x.astype(infer_dtype)`` in the JAX serving
        path)."""
        x = x.to(self.dtype)
        x, (h0, w0) = pad_to_window_multiple(x, _lcm_all(self.window_size))
        x = self.head(self.sub_mean(x))
        tokens, x_size = to_tokens(x)
        if self.patch_embed is not None:
            tokens = self.patch_embed.norm(tokens)
        tokens = self.pos_drop(tokens)
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


def set_kernel_mode(model: RDSTSR, mode: str, softmax: str = "") -> list:
    """Route ``model``'s blocks for kernel mode ``mode`` ('' for the plain
    path) at the model's dtype, with the bf16 kernels' ``softmax``
    variant; sets ``model.kernel_mode``, ``model.softmax`` and
    ``model.routes`` (the kernel each RDSTB runs) and returns the routes.

    float32: every mode runs each Swin block on the f32 block kernel.
    bfloat16: 'rdstb' -> ``fused_rdstb`` per RDSTB, 'pair' ->
    ``fused_swin_pair`` per DSTL, 'swin'/'pack' -> the fast
    ``fused_swin_block`` per block ('pack', the TPU's two-windows-per-lane
    layout, computes the same function). An RDSTB the mode's kernel
    cannot take raises, naming the mode to choose instead."""
    from rdst_tpu_torch.kernels.swin_block import softmax_code
    from rdst_tpu_torch.kernels.window_attention import KERNEL_MODES

    if mode and mode not in KERNEL_MODES:
        raise ValueError(f"kernel mode {mode!r}: expected one of "
                         f"{KERNEL_MODES} or ''")
    bf16 = model.dtype == BF16
    if bf16:
        softmax_code(softmax)  # raises on a variant the kernels lack
    set_block_kernels(model, False)
    for m in model.modules():
        if isinstance(m, BasicLayer):
            m.use_pair = False
        if isinstance(m, RDSTB):
            m.use_rdstb = False
        if hasattr(m, "softmax"):
            m.softmax = softmax
    routes = []
    for i, block in enumerate(model.body):
        if not mode:
            routes.append("plain")
        elif not bf16 or mode in ("swin", "pack"):
            for layer in block.body:
                for blk in layer.body.blocks:
                    why = (blk.fast_unsupported() if bf16
                           else blk.f32_unsupported())
                    if why:
                        kind = "fast" if bf16 else "f32"
                        raise ValueError(
                            f"RDSTB {i}: the {kind} block kernel cannot run "
                            f"it ({why}); build with pallas_kernels='off'")
            set_block_kernels(block, True)
            routes.append("fused_swin_block")
        elif mode == "pair":
            for layer in block.body:
                why = layer.body.pair_unsupported()
                if why:
                    raise ValueError(
                        f"RDSTB {i}: the pair kernel cannot run it ({why}); "
                        "build with pallas_kernels='swin' or 'off'")
                layer.body.use_pair = True
            routes.append("fused_swin_pair")
        else:
            why = block.rdstb_unsupported()
            if why:
                raise ValueError(
                    f"RDSTB {i}: the RDSTB kernel cannot run it ({why}); "
                    "build with pallas_kernels='pair' or 'off'")
            block.use_rdstb = True
            routes.append("fused_rdstb")
    model.kernel_mode, model.softmax, model.routes = mode, softmax, routes
    return routes


def set_train_mode(model: RDSTSR, mode: str) -> str:
    """Decide the training route of ``model`` once (``model.train_mode``,
    returned). float32 trains on the plain modules whatever ``mode``
    says (the JAX train kernels need bf16). bfloat16: 'pair' runs each
    DSTL pair on the train-pair kernels and raises, naming
    ``pallas_train='off'``, for a layer they cannot take (dropout rates
    included); '' runs the plain bf16 modules; 'block' raises."""
    layers = [m for m in model.modules() if isinstance(m, BasicLayer)]
    for layer in layers:
        layer.use_pair_train = False
    if model.dtype != BF16:
        mode = ""
    if mode == "block":
        raise NotImplementedError(
            "pallas_train='block' (fused_swin_block_train, for widths a "
            "pair cannot hold) comes with the wide-width slice of the port "
            "(ROADMAP Queue B 6); use 'pair' or 'off'")
    if mode not in ("", "pair"):
        raise ValueError(f"pallas_train={mode!r}: expected 'pair' or ''")
    if mode == "pair":
        for layer in layers:
            why = layer.pair_train_unsupported()
            if why:
                raise ValueError(f"the train-pair kernels cannot run a DSTL "
                                 f"({why}); build with pallas_train='off'")
            layer.use_pair_train = True
    model.train_mode = mode
    return mode


def make_rdst(paras, mean=None, std=None, dtype=torch.float32) -> RDSTSR:
    """Factory keyed off the reference config names (the JAX package's
    ``make_rdst``), in float32 or bfloat16. The kernel mode
    (``pallas_kernels``, else ``RDST_TORCH_KERNELS``) and the softmax
    variant (``pallas_softmax``, 'auto' resolved against the configured
    checkpoint's stats sidecar) are resolved here, once, and the routes
    set by :func:`set_kernel_mode`."""
    from rdst_tpu_torch.checkpoint.loading import (resolve_model_path,
                                                   resolve_pallas_softmax)
    from rdst_tpu_torch.kernels.window_attention import kernel_flags

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
        dtype=dtype,
        drop_rate=float(paras.get("swin_drop_rate", 0.0) or 0.0),
        attn_drop=float(paras.get("swin_attn_drop_rate", 0.0) or 0.0),
    )
    flags = kernel_flags(paras)
    softmax = resolve_pallas_softmax(resolve_model_path(paras), flags.softmax)
    set_kernel_mode(model, flags.kernels, softmax)
    return model.eval()
