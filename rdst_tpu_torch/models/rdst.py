"""RDST -- Residual Dense Swin Transformer SR (counterpart of
``rdst_tpu/models/rdst.py``).

* DenseSTLayer (DSTL): a Swin block pair (shift 0 / ws//2) + a linear
  dim adapter at 'head' or 'tail' + a dense channel concat;
* RDSTB: DSTLs with the input dim growing by growth_rate, then a 3x3
  conv bottleneck back to embed_dim (or the '3conv' stack,
  :func:`conv_stack`) and a scaled residual; RRDSTB (ESTSR's unit):
  RDSTBs, a conv and a scaled residual;
* RDSTSR: mean-shift -> head conv -> patch LayerNorm (-> the absolute
  position table with ``ape``) -> RDSTBs over tokens (each recomputed in
  the backward with ``remat``) -> LayerNorm -> conv_after_body -> global
  residual -> PixelShuffle tail, or with ``scale_free`` the
  ``tail_meta`` MetaUpSampler at the scale the model is called with
  (``forward(x, sr_scale)``), cropped to ``int(orig_hw * s)``; the head
  and the tail are :class:`SRFrame`'s, which RDST-N and ESTSR share.

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
kernels (``pallas_train='pair'``, the default), each block on the
single-block train kernel (``'block'``) or the plain bf16 modules
(``'off'``), as decided once by :func:`set_train_mode`. Both route
functions live in ``models.routes`` (they serve any model of
``BasicLayer`` s) and are imported here under their old names.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rdst_tpu_torch.device import device_table
from rdst_tpu_torch.models.meta_upscale import MetaUpSampler, scale_value
from rdst_tpu_torch.models.routes import (  # noqa: F401 (old names)
    set_kernel_mode, set_train_mode)
from rdst_tpu_torch.nn.common import Conv, MeanShift, UpSampler
from rdst_tpu_torch.nn.layers import (BF16, Dropout, LayerNorm, LeakyReLU,
                                      Linear)
from rdst_tpu_torch.nn.swin import (BasicLayer, kernel_plan, refuse_grad,
                                    resolve_ws_shift)


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
        x = x.index_select(1, _reflect_index_on(h, h + ph, x.device))
    if pw:
        x = x.index_select(2, _reflect_index_on(w, w + pw, x.device))
    return x, (h, w)


@device_table(64)
def _reflect_index_on(size: int, padded: int,
                      device: torch.device) -> torch.Tensor:
    """:func:`reflect_index` on ``device``, made once a geometry (outside
    inference mode, as ``nn.swin``'s cached tables): a forward then copies
    nothing from the host, so a CUDA graph can capture it."""
    with torch.inference_mode(False):
        return reflect_index(size, padded).to(device)


def position_table(resolution, multiple: int, dim: int) -> nn.Parameter:
    """An absolute position table (``rdst_ape`` / ``sir_ape``) of one row a
    token of ``resolution`` padded to whole windows (``multiple``): the
    JAX table's length is the token count of the input it was initialized
    at (the trainer's: one training patch)."""
    h, w = (-(-int(s) // multiple) * multiple for s in resolution)
    return nn.Parameter(torch.zeros(1, h * w, dim))


def fit_position_table(table, state_dict, key: str) -> None:
    """Before a ``state_dict`` load: the table takes the length of the one
    carried over."""
    if table is not None and key in state_dict and \
            state_dict[key].shape != table.shape:
        table.data = table.new_zeros(state_dict[key].shape)


def add_position_table(tokens: torch.Tensor, table, x_size,
                       option: str) -> torch.Tensor:
    """``tokens + table``; another token count than the table's raises and
    names both (the JAX apply fails there). In bf16 the table is rounded,
    so the tokens stay bf16 (the JAX package promotes them to float32)."""
    if table.shape[1] != tokens.shape[1]:
        raise ValueError(
            f"absolute_pos_embed has {table.shape[1]} positions, the input "
            f"{tuple(x_size)} {tokens.shape[1]} tokens: the table ({option}) "
            "is sized by the token count the model was initialized at, and "
            "takes inputs of that size only")
    return tokens + table.to(tokens.dtype)


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


def conv_stack(c_in: int, c_out: int, resi_connection: str) -> nn.Module:
    """The residual conv of an RDSTB (C_in = its dense width) or of
    ``conv_after_body``: '1conv' one 3x3 conv; '3conv' a 3x3 conv to
    C_in // 4, leaky ReLU 0.2, a 1x1 conv, leaky ReLU, a 3x3 conv to
    C_out (the flax ``conv_0`` / ``conv_2`` / ``conv_4`` at indices 0, 2,
    4)."""
    if resi_connection == "1conv":
        return Conv(c_in, c_out, 3)
    if resi_connection == "3conv":
        q = c_in // 4
        return nn.Sequential(Conv(c_in, q, 3), LeakyReLU(0.2), Conv(q, q, 1),
                             LeakyReLU(0.2), Conv(q, c_out, 3))
    raise ValueError(f"resi_connection {resi_connection!r}: expected "
                     "'1conv' or '3conv'")


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
        self.resi_connection = resi_connection
        self.residual_scale = residual_scale
        self.input_dim, self.growth_rate = input_dim, growth_rate
        self.num_heads, self.window_size = num_heads, window_size
        self.mlp_ratio, self.pre_norm = mlp_ratio, pre_norm
        self.layer_depth, self.layer_norm = layer_depth, layer_norm
        self.qk_scale, self.dense_scale = qk_scale, dense_scale
        self.dim_modify_mode = dim_modify_mode
        self.build_resolution = build_resolution
        self.use_rdstb = False  # see set_kernel_mode
        self.quant = frozenset()  # int8 groups of the RDSTB kernel route
        self.softmax = ""
        self.body = nn.ModuleList([
            DenseSTLayer(input_dim + i * growth_rate, growth_rate,
                         layer_depth, num_heads, window_size, mlp_ratio,
                         qkv_bias, qk_scale, dense_scale, dim_modify_mode,
                         pre_norm, build_resolution, layer_norm, drop,
                         attn_drop)
            for i in range(int(num_blocks))])
        self.conv = conv_stack(input_dim + int(num_blocks) * growth_rate,
                               input_dim, resi_connection)

    def _window(self, h: int, w: int) -> Tuple[int, int]:
        return resolve_ws_shift(self.build_resolution or (h, w), h, w,
                                self.window_size, self.window_size // 2)

    def rdstb_unsupported(self, quant=frozenset()) -> Optional[str]:
        """Why the RDSTB kernel cannot run this block with the int8 groups
        ``quant`` (None when it can): the structure
        ``RDSTB._use_fused_rdstb`` asks for in the JAX package, and what
        the CUDA kernels take at the build resolution. Checked when the
        model is built; the wrapper checks the runtime geometry again at
        every call."""
        from rdst_tpu_torch.kernels.quant import mm_quant_groups
        from rdst_tpu_torch.kernels.rdstb_block import rdstb_kernel_supports

        nb = len(self.body)
        widths = [self.input_dim + i * self.growth_rate for i in range(nb)]
        if self.resi_connection != "1conv":
            return (f"resi_connection {self.resi_connection!r}: the kernel "
                    "ends in the one-conv bottleneck")
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
                                     self.mlp_ratio,
                                     bool(mm_quant_groups(quant))):
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
            self, ("rdstb", x_size, ws, shift, x.device, self.quant),
            lambda: plan_rdstb(*self.rdstb_inputs(x_size, ws, shift),
                               num_heads=self.num_heads,
                               growth=self.growth_rate,
                               adapter_prenorm=self.pre_norm,
                               quant=self.quant))
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


class RRDSTB(nn.Module):
    """Residual-in-residual dense Swin block (the JAX package's
    ``RRDSTB``, ESTSR's unit): ``num_rdstb`` RDSTBs, a 3x3 conv, then
    ``conv(x) * residual_scale + shortcut``. Its RDSTBs take the RDSTB
    defaults for the q/k/v bias, the q scale, the dropout rates and the
    LayerNorms, whatever the config says, as the JAX ``RRDSTB`` hands
    them none."""

    def __init__(self, input_dim: int, num_rdstb: int = 3,
                 layer_depth: int = 2, num_heads: int = 6,
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 resi_connection: str = "1conv", growth_rate: int = 30,
                 dense_scale: float = 1.0, dim_modify_mode: str = "tail",
                 rdb_depth: int = 3, rdb_residual_scale: float = 1.0,
                 residual_scale: float = 1.0, pre_norm: bool = False,
                 build_resolution: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.residual_scale = float(residual_scale)
        self.body = nn.ModuleList([
            RDSTB(input_dim, layer_depth, num_heads, window_size, mlp_ratio,
                  resi_connection=resi_connection, growth_rate=growth_rate,
                  dense_scale=dense_scale, dim_modify_mode=dim_modify_mode,
                  num_blocks=rdb_depth, residual_scale=rdb_residual_scale,
                  pre_norm=pre_norm, build_resolution=build_resolution)
            for _ in range(int(num_rdstb))])
        self.conv = Conv(input_dim, input_dim, 3)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        shortcut = x
        for block in self.body:
            x = block(x, x_size)
        y, _ = to_tokens(self.conv(to_image(x, x_size)))
        return y * self.residual_scale + shortcut


class _PatchEmbed(nn.Module):
    """Holds the patch-embedding LayerNorm (state_dict ``patch_embed.norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class SRFrame(nn.Module):
    """What RDSTSR, RDSTSR_N (``models.rdst_n``) and ESTSR
    (``models.estsr``) share around their bodies: the mean shift, the head
    conv, the patch LayerNorm and the absolute position embedding before
    it (:meth:`_head`, :meth:`_embed`); the PixelShuffle tail or the
    scale-free ``tail_meta`` MetaUpSampler and the crop after it
    (:meth:`_tail`, :meth:`_upsample`). ``route_units()`` are the
    RDSTBs (:meth:`rdstbs`)."""

    def _head(self, in_chans: int, embed_dim: int, window_size, mean, std,
              patch_norm: bool, ape: bool, build_resolution,
              dtype: torch.dtype) -> None:
        if dtype not in (torch.float32, BF16):
            raise NotImplementedError(
                f"{type(self).__name__} in {dtype}: the port computes in "
                "float32 or bfloat16")
        self.dtype = dtype
        self.train_mode = ""  # plain autograd until set_train_mode
        self.train_routes = {"pair": 0, "block": 0}
        # training patches are built at the build resolution (24x24 LR)
        self.train_resolution = build_resolution
        self.window_size = tuple(window_size)
        self.mean, self.std = tuple(mean), tuple(std)
        self.sub_mean = MeanShift(mean, std, "sub")
        self.add_mean = MeanShift(mean, std, "add")
        self.head = Conv(in_chans, embed_dim, 3)
        self.patch_embed = _PatchEmbed(embed_dim) if patch_norm else None
        self.absolute_pos_embed = (position_table(
            build_resolution, _lcm_all(window_size), embed_dim) if ape
            else None)

    def _tail(self, in_chans: int, sr_scale, tail_dim: int,
              drop_rate: float, scale_free: bool) -> None:
        self.sr_scale = int(sr_scale)
        self.pos_drop = Dropout(drop_rate)
        self.scale_free = bool(scale_free)
        if self.scale_free:
            self.tail_meta = MetaUpSampler(tail_dim, in_chans)
        else:
            self.tail = nn.Sequential(
                UpSampler(self.sr_scale, tail_dim) if self.sr_scale > 1
                else nn.Identity(),
                Conv(tail_dim, in_chans, 3))

    def rdstbs(self):
        return list(self.body)

    def route_units(self):
        """The units a kernel route is decided for: the RDSTBs."""
        return [("RDSTB", b) for b in self.rdstbs()]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        fit_position_table(self.absolute_pos_embed, state_dict,
                           prefix + "absolute_pos_embed")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _embed(self, x: torch.Tensor):
        """NHWC LR -> (the head conv's output, the tokens the body takes,
        their (H, W), the unpadded LR (h0, w0))."""
        x = x.to(self.dtype)
        x, hw0 = pad_to_window_multiple(x, _lcm_all(self.window_size))
        x = self.head(self.sub_mean(x))
        tokens, x_size = to_tokens(x)
        if self.patch_embed is not None:
            tokens = self.patch_embed.norm(tokens)
        if self.absolute_pos_embed is not None:
            tokens = add_position_table(tokens, self.absolute_pos_embed,
                                        x_size, "rdst_ape")
        return x, self.pos_drop(tokens), x_size, hw0

    def _upsample(self, res: torch.Tensor, scale, hw0) -> torch.Tensor:
        """The tail on ``res`` (head features + scaled body residual),
        the mean added back, the window padding cropped (at the real
        scale when scale-free)."""
        h0, w0 = hw0
        if self.scale_free:
            out = self.add_mean(self.tail_meta(res, scale))
            return out[:, : int(h0 * scale), : int(w0 * scale), :]
        out = self.add_mean(self.tail(res))
        s = self.sr_scale
        return out[:, : h0 * s, : w0 * s, :]


def remat(block: nn.Module, x: torch.Tensor, x_size) -> torch.Tensor:
    """``block(x, x_size)`` with its activations recomputed in the
    backward (the JAX ``nn.remat(RDSTB)`` of ``rdst_remat``): the same
    numbers, less memory. The generators its dropout layers draw from are
    rewound for the recompute, so that it draws what the forward drew."""
    from torch.utils.checkpoint import checkpoint

    gens = {id(g): g for m in block.modules()
            if (g := getattr(m, "generator", None)) is not None}
    start = {k: g.get_state() for k, g in gens.items()}
    calls = []

    def run(t):
        if not calls:
            calls.append(1)
            return block(t, x_size)
        now = {k: g.get_state() for k, g in gens.items()}
        for k, g in gens.items():
            g.set_state(start[k])
        try:
            return block(t, x_size)
        finally:
            for k, g in gens.items():
                g.set_state(now[k])

    return checkpoint(run, x, use_reentrant=False)


class RDSTSR(SRFrame):
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
                 attn_drop: float = 0.0, scale_free: bool = False,
                 ape: bool = False, remat: bool = False):
        super().__init__()
        # no drop path rate: the JAX RDSTSR takes swin_drop_path_rate but
        # never hands it to its RDSTBs (rdst_tpu/models/rdst.py:410-428),
        # so stochastic depth stays off in RDST training
        if not (len(rdb_depths) == len(window_size) == len(num_heads)
                == len(dense_layer_depths)):
            raise ValueError("per-RDSTB config lists differ in length")
        self._head(in_chans, embed_dim, window_size, mean, std,
                   patch_norm and layer_norm, ape, build_resolution, dtype)
        self.layer_norm = layer_norm
        self.global_res_scale = global_res_scale
        # rdst_remat: each RDSTB's activations recomputed in the backward
        self.remat = bool(remat)
        self.body = nn.ModuleList([
            RDSTB(embed_dim, dense_layer_depths[i], num_heads[i],
                  window_size[i], mlp_ratio, qkv_bias, qk_scale,
                  resi_connection, growth_rate, dense_scale, dim_modify_mode,
                  rdb_depths[i], rdb_residual_scale, pre_norm,
                  build_resolution, layer_norm, drop_rate, attn_drop)
            for i in range(len(rdb_depths))])
        self.norm = LayerNorm(embed_dim) if layer_norm else None
        self.conv_after_body = (conv_stack(embed_dim, embed_dim,
                                           resi_connection)
                                if feature_last_operation else None)
        self._tail(in_chans, sr_scale, embed_dim, drop_rate, scale_free)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        """NHWC LR -> HR in the model's dtype (bf16: the input is rounded
        to bf16 first, as ``x.astype(infer_dtype)`` in the JAX serving
        path). ``sr_scale`` is read by a scale-free model only, which
        needs it."""
        scale = scale_value(sr_scale) if self.scale_free else None
        x, tokens, x_size, hw0 = self._embed(x)
        again = self.remat and self.training and torch.is_grad_enabled()
        for block in self.body:
            tokens = (remat(block, tokens, x_size) if again
                      else block(tokens, x_size))
        if self.norm is not None:
            tokens = self.norm(tokens)
        res = to_image(tokens, x_size)
        if self.global_res_scale != 1.0:
            res = res * self.global_res_scale
        if self.conv_after_body is not None:
            res = self.conv_after_body(res)
        return self._upsample(res + x, scale, hw0)


def route_by_config(model: nn.Module, paras) -> nn.Module:
    """Decide ``model``'s kernel routes once from the config's kernel keys:
    the mode (``pallas_kernels``, else ``RDST_TORCH_KERNELS``), the
    softmax variant (``pallas_softmax``, 'auto' resolved against the
    configured checkpoint's stats sidecar) and the int8 groups
    (``pallas_quant``), by :func:`set_kernel_mode`; returns the model in
    eval mode."""
    from rdst_tpu_torch.checkpoint.loading import (resolve_model_path,
                                                   resolve_pallas_softmax)
    from rdst_tpu_torch.kernels.window_attention import kernel_flags

    flags = kernel_flags(paras)
    softmax = resolve_pallas_softmax(resolve_model_path(paras), flags.softmax)
    set_kernel_mode(model, flags.kernels, softmax, flags.quant)
    return model.eval()


def make_rdst(paras, mean=None, std=None, dtype=torch.float32) -> nn.Module:
    """Factory keyed off the reference config names (the JAX package's
    ``make_rdst``), in float32 or bfloat16; ``rdst_global_bottleneck``
    builds RDST-N (``models.rdst_n``). Routes by :func:`route_by_config`."""
    if paras.rdst_global_bottleneck:
        from rdst_tpu_torch.models.rdst_n import make_rdst_n

        return make_rdst_n(paras, mean, std, dtype)
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
        scale_free=bool(paras.scale_free),
        ape=bool(paras.rdst_ape),
        remat=bool(paras.get("rdst_remat", False)),
    )
    return route_by_config(model, paras)
