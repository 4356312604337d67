"""A whole RDSTB in one call: the CUDA stage kernels and their plain
PyTorch versions.

Counterpart of ``rdst_tpu/kernels/rdstb_block.py::fused_rdstb`` (bf16 fast
branch only, as there). On image-major tokens (B, H*W, C0), per DSTL:
block a on the windows of the dense features, the shift relayout, block
b, the inverse relayout, the tail adapter (Dense C->growth then LN, or
with ``adapter_prenorm`` the LN(C) affine folded into the Dense), and the
dense concat; then the 3x3 conv from C0 + nb*growth channels back to C0
(weights tap-major (9*C_cat, C0), as ``_conv3x3``) and the residual.
``quant`` (any of 'qkv', 'mlp', 'proj', 'conv') puts those groups'
products on int8 operands (``kernels.quant``): the blocks' as the fast
block does, the conv on the dense concat quantized at a dynamic scale,
its nine taps summed in int32 and dequantized once; each dynamic scale
over the images of one JAX program (``quant.rdstb_group_images``).

:func:`fused_rdstb` prepares the weights (:func:`plan_rdstb`) and calls
:func:`run_rdstb`, which launches the stage kernels of
``csrc/rdstb_block.cu`` for a CUDA tensor (per DSTL: stage A, block a
into an image-layout scratch; stage B, block b on the rolled windows,
the adapter, the growth channels into the dense rows; then the conv as a
tiled implicit GEMM, with int8 'conv' after a pass that takes each
group's amax of the dense rows) and counts the call in
``run_rdstb.launches`` and
its kernels in ``run_rdstb.kernels``; for a CPU tensor it computes
:func:`rdstb_reference`. Each DSTL's stages run in the design
``stage_route`` picks by width and int8 products (:func:`dstl_routes`):
one kernel a stage on the window body, or five to eight a stage
(``token_fwd_kernels``; and the adapter's one or two) on the
token-parallel forward. :func:`rdstb_staged_reference` computes
stage by stage what the kernels compute, over their buffer layouts. What
the kernels do not take raises on either device. The JAX package's
``fused_rdstb_probe`` (a Mosaic compile probe that let a geometry fall
back quietly) has no counterpart: the port's gate is
:func:`rdstb_kernel_supports`, checked when the model is built and again
at every call, and a refusal raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch.nn import functional as F

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.quant import (BlockQuant, ConvQuant,
                                          block_quant, check_ported,
                                          conv_quant, quant_dyn,
                                          rdstb_group_images)
from rdst_tpu_torch.kernels.swin_block import (
    BF16, FAST_MAX_C, H100_SMEM_OPTIN, FastParams, _EPS, _round_up,
    check_fast_tokens, fast_body, fast_params, int8_mask, int8_token_layout,
    kernel_layout, launch, normalize, pack_bias_fast, qkv_token_layout,
    softmax_code, stage_route, token_fwd_kernels, token_kernel_supports,
    token_layout, token_smem_bytes, token_wgmma_layout, work_bytes)
from rdst_tpu_torch.kernels.swin_pair import (shift_relayout,
                                              unshift_relayout)
from rdst_tpu_torch.kernels.window_body import (BODY_MAX_C, body_supports,
                                                conv_panels,
                                                conv_smem_bytes, make_geom,
                                                stage_bias, stage_fit,
                                                stage_layout, window_pixels)
from rdst_tpu_torch.nn.swin import window_partition, window_reverse

_SOURCE = "rdstb_block.cu"
MAX_DSTLS = 4  # DSTLs one launch takes (kMaxDstl in the CUDA source)
CONV_MAX_C0 = 128  # C0 the conv's output tiles take


class Adapter(NamedTuple):
    """A DSTL's tail adapter as the kernel reads it."""
    w: torch.Tensor      # (C, g) bf16 (pre-norm: the LN affine folded in)
    b: torch.Tensor      # (g,) f32
    gamma: torch.Tensor  # (g,) f32 post-norm LN scale (pre-norm: unused)
    beta: torch.Tensor   # (g,) f32


class PreppedDstl(NamedTuple):
    pa: FastParams
    bias_a: torch.Tensor  # packed (1, N, nH*N) bf16
    pb: FastParams
    bias_b: torch.Tensor  # packed (nW or 1, N, nH*N) bf16
    adapter: Adapter
    quant_a: BlockQuant = BlockQuant()  # int8 operands of block a by group
    quant_b: BlockQuant = BlockQuant()

    @property
    def qa(self):
        """Block a's int8 qkv operands, or None."""
        return self.quant_a.qkv

    @property
    def qb(self):
        return self.quant_b.qkv

    @property
    def int8_mask(self) -> int:
        return int8_mask(self.quant_a.mlp, self.quant_a.proj)


def prep_adapter(wa, ba, ga, bba, prenorm: bool) -> Adapter:
    """The adapter as ``_fused_rdstb_impl`` ships it (:460-476):
    post-norm keeps the Dense in bf16 (bias rounded to bf16, read as f32)
    and the LN affine in f32; pre-norm folds the LN(C) affine into the
    Dense, (x^ g + b)W + c = x^ (g W) + (bW + c), from the bf16-rounded
    Dense, the folded bias in f32."""
    f32 = torch.float32
    if prenorm:
        wdt = wa.to(BF16).to(f32)
        wa_f = ga.to(f32)[:, None] * wdt
        ba_f = bba.to(f32) @ wdt + ba.to(BF16).to(f32)
        return Adapter(wa_f.to(BF16), ba_f, ba_f, ba_f)
    return Adapter(wa.to(BF16), ba.to(BF16).to(f32), ga.to(f32),
                   bba.to(f32))


def prep_dstls(dstls, c0: int, growth: int, nh: int, n: int,
               prenorm: bool, quant=frozenset()) -> List[PreppedDstl]:
    """Fold every DSTL's two blocks (``prep_block_params``), pack their
    biases and prepare the adapters; with int8 groups in ``quant`` also
    each block's int8 operands of those groups from its folded weights
    (the JAX ``mm_quant_extras``)."""
    groups = check_ported(quant)
    out = []
    c = c0
    for d in dstls:
        (pa, bias_a), (pb, bias_b) = d["blocks"]
        fa, fb = fast_params(pa, c, nh), fast_params(pb, c, nh)
        out.append(PreppedDstl(
            fa, pack_bias_fast(bias_a, nh, n), fb,
            pack_bias_fast(bias_b, nh, n),
            prep_adapter(*d["adapter"], prenorm),
            block_quant(fa, groups), block_quant(fb, groups)))
        c += growth
    return out


def conv_rows(conv_kernel):
    """HWIO (3, 3, C_cat, C0) -> tap-major (9*C_cat, C0) bf16 rows
    (dy, dx, cin), as ``_fused_rdstb_impl`` reshapes it."""
    kh, kw, ccat, c0 = conv_kernel.shape
    return conv_kernel.to(BF16).reshape(kh * kw * ccat, c0)


def _image_to_windows(x_img, ws: int):
    b, h, w, c = x_img.shape
    return window_partition(x_img, ws).reshape(-1, ws * ws, c)


def conv3x3_int8(img, conv: ConvQuant, bc, groups: int):
    """``_conv3x3`` with the int8 'conv' group: the image (B, H, W, C_cat)
    quantized at a dynamic scale over each of ``groups`` runs of images,
    the nine taps of the int8 product summed exactly, dequantized once:
    ``int32 * (ws * dq) + bc``; returns float32 (B, H, W, C0)."""
    b, h, w, ccat = img.shape
    c0 = conv.ws.shape[0]
    q, dq = quant_dyn(img.float(), groups)
    kern = conv.wq.double().reshape(3, 3, ccat, c0).permute(3, 2, 0, 1)
    acc = torch.nn.functional.conv2d(q.double().permute(0, 3, 1, 2), kern,
                                     padding=1).float().permute(0, 2, 3, 1)
    scale = conv.ws * dq.repeat_interleave(b // groups).reshape(b, 1, 1, 1)
    return acc * scale + bc.float()


def rdstb_reference(x_tokens, prepped: List[PreppedDstl], wc, bc, *,
                    num_heads: int, x_size, window_size: int, shift: int,
                    growth: int, adapter_prenorm: bool, softmax: str,
                    conv: Optional[ConvQuant] = None,
                    group_images: Optional[int] = None):
    """Plain PyTorch version of the RDSTB kernel: bf16 image-major tokens
    (B, H*W, C0), prepared DSTLs (with their blocks' int8 operands), the
    tap-major bf16 conv rows (9*C_cat, C0), the f32 conv bias and the
    conv's int8 operands (or None); each dynamic int8 scale over runs of
    ``group_images`` images (None: the whole batch); returns bf16 (B,
    H*W, C0)."""
    b, l, c0 = x_tokens.shape
    h, w = x_size
    ws = window_size
    nw = (h // ws) * (w // ws)
    gi = b if group_images is None else group_images
    gw = gi * nw
    x0 = x_tokens
    feats = [_image_to_windows(x0.reshape(b, h, w, c0), ws)]
    for d in prepped:
        xin = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        y = fast_body(xin.float(), d.pa, d.bias_a, num_heads=num_heads,
                      softmax=softmax, group_windows=gw,
                      **d.quant_a._asdict()).to(BF16)
        y = shift_relayout(y, x_size, ws, shift)
        y = fast_body(y.float(), d.pb, d.bias_b, num_heads=num_heads,
                      softmax=softmax, group_windows=gw,
                      **d.quant_b._asdict()).to(BF16)
        y = unshift_relayout(y, x_size, ws, shift)
        ad = d.adapter
        if adapter_prenorm:
            a = normalize(y.float()).to(BF16).float() @ ad.w.float() + ad.b
        else:
            a = y.float() @ ad.w.float() + ad.b
            mu = a.mean(dim=-1, keepdim=True)
            ac = a - mu
            var = (ac * ac).mean(dim=-1, keepdim=True)
            a = ac * torch.rsqrt(var + _EPS) * ad.gamma + ad.beta
        feats.append(a.to(BF16))
    cat = torch.cat(feats, dim=-1)
    ccat = cat.shape[-1]
    img = window_reverse(cat.reshape(-1, ws, ws, ccat), ws, h, w)
    if conv is not None:
        out = conv3x3_int8(img, conv, bc, b // gi).reshape(b, l, c0)
        return (out + x0.float()).to(BF16)
    kern = wc.float().reshape(3, 3, ccat, c0).permute(3, 2, 0, 1)
    out = F.conv2d(img.permute(0, 3, 1, 2).float(), kern, padding=1)
    out = out.permute(0, 2, 3, 1).reshape(b, l, c0)
    return (out + bc.float() + x0.float()).to(BF16)


def rdstb_staged_reference(x_tokens, prepped: List[PreppedDstl], wc, bc,
                           *, num_heads: int, x_size, window_size: int,
                           shift: int, growth: int, adapter_prenorm: bool,
                           softmax: str, conv: Optional[ConvQuant] = None,
                           group_images: Optional[int] = None):
    """The RDSTB's stage kernels in plain PyTorch (same arguments as
    :func:`rdstb_reference`), over the kernels' buffers: the dense rows
    (B, H*W, ccatp) = x0 | feats | zeros; per DSTL, stage A (block a on
    the unshifted windows of the dense rows, gathered by the kernels'
    index rule, :func:`window_pixels`; its bf16 rows into y (B, H*W, c8)
    at their pixels) and stage B (the rolled windows gathered from y,
    block b, bf16, the adapter, the growth channels into the dense rows at
    the same pixels); then the conv as the kernel's implicit GEMM: per tap,
    the zero-bordered dense rows shifted by the tap times the tap's
    (ccatp, C0) weight, summed over the nine taps in f32, plus bias and
    x0, bf16; with int8 ``conv``, the dense rows quantized at each image
    group's scale (``group_images`` images; their pad is zero), the taps
    summed exactly, dequantized once. Both stage designs compute this."""
    b, l, c0 = x_tokens.shape
    h, w = x_size
    ws = window_size
    nh = num_heads
    n = ws * ws
    nw = (h // ws) * (w // ws)
    nb = len(prepped)
    ccat = c0 + nb * growth
    ccatp = _round_up(ccat, 16)
    gi = b if group_images is None else group_images
    gw = gi * nw
    dev = x_tokens.device
    dense = torch.zeros(b, l, ccatp, dtype=BF16, device=dev)
    dense[..., :c0] = x_tokens
    unshifted = window_pixels(h, w, ws, 0).reshape(-1)
    rolled = window_pixels(h, w, ws, shift).reshape(-1)
    for i, d in enumerate(prepped):
        c = c0 + i * growth
        c8 = make_geom(n, c, nh, d.pa.w1.shape[1]).c8
        rows = dense[:, unshifted, :c].reshape(b * nw, n, c)
        ya = fast_body(rows.float(), d.pa, d.bias_a, num_heads=nh,
                       softmax=softmax, group_windows=gw,
                       **d.quant_a._asdict()).to(BF16)
        y = torch.zeros(b, l, c8, dtype=BF16, device=dev)
        y[:, unshifted, :c] = ya.reshape(b, nw * n, c)
        rows = y[:, rolled, :c].reshape(b * nw, n, c)
        z = fast_body(rows.float(), d.pb, d.bias_b, num_heads=nh,
                      softmax=softmax, group_windows=gw,
                      **d.quant_b._asdict()).to(BF16).float()
        ad = d.adapter
        if adapter_prenorm:
            a = normalize(z).to(BF16).float() @ ad.w.float() + ad.b
        else:
            a = z @ ad.w.float() + ad.b
            mu = a.mean(dim=-1, keepdim=True)
            ac = a - mu
            var = (ac * ac).mean(dim=-1, keepdim=True)
            a = ac * torch.rsqrt(var + _EPS) * ad.gamma + ad.beta
        dense[:, rolled, c:c + growth] = a.to(BF16).reshape(b, nw * n,
                                                            growth)
    x0 = dense[..., :c0].float()
    if conv is not None:
        q, dq = quant_dyn(dense.float(), b // gi)
        img = F.pad(q.reshape(b, h, w, ccatp).float(), (0, 0, 1, 1, 1, 1))
        taps = torch.zeros(9, ccatp, c0, dtype=torch.float64, device=dev)
        taps[:, :ccat] = conv.wq.double().reshape(9, ccat, c0)
        acc = torch.zeros(b, h, w, c0, dtype=torch.float64, device=dev)
        for t in range(9):  # int32 sums, exact in float64
            dy, dx = divmod(t, 3)
            acc = acc + img[:, dy:dy + h, dx:dx + w].double() @ taps[t]
        scale = conv.ws * dq.repeat_interleave(gi).reshape(b, 1, 1, 1)
        out = (acc.float() * scale + bc.float()).reshape(b, l, c0)
        return (out + x0).to(BF16)
    img = F.pad(dense.reshape(b, h, w, ccatp).float(), (0, 0, 1, 1, 1, 1))
    taps = torch.zeros(9, ccatp, c0, dtype=torch.float32, device=dev)
    taps[:, :ccat] = wc.float().reshape(9, ccat, c0)
    out = torch.zeros(b, h, w, c0, dtype=torch.float32, device=dev)
    for t in range(9):
        dy, dx = divmod(t, 3)
        out = out + img[:, dy:dy + h, dx:dx + w] @ taps[t]
    out = out.reshape(b, l, c0) + bc.float() + x0
    return out.to(BF16)


def dstl_routes(c0: int, growth: int, nb: int, int8: bool) -> List[str]:
    """Each DSTL's stage design (``stage_route`` of its width; ``int8``:
    any of the blocks' int8 groups, 'qkv', 'mlp', 'proj', is on; 'conv'
    alone moves no DSTL): 'window' or 'tokens'."""
    return [stage_route(c0 + d * growth, int8) for d in range(nb)]


def rdstb_stage_smem_bytes(n: int, c0: int, growth: int, nb: int, nh: int,
                           hidden_ratio: float, int8: bool = False
                           ) -> List[int]:
    """The most dynamic shared memory a kernel of each of a call's stages
    takes (``rdstb_stage_smem_bytes`` in the CUDA source for the window
    body), in launch order: per DSTL stage A and stage B (with the
    adapter's rows or tile), then the conv; 0 for a window-body stage
    that does not fit."""
    out = []
    for d, route in enumerate(dstl_routes(c0, growth, nb, int8)):
        c = c0 + d * growth
        hidden = int(c * hidden_ratio)
        if route == "tokens":
            out += [token_smem_bytes(n, c, nh, hidden),
                    token_smem_bytes(n, c, nh, hidden, growth)]
            continue
        g = make_geom(n, c, nh, hidden)
        out += [stage_fit(g).smem, stage_fit(g, _round_up(growth, 32)).smem]
    return out + [conv_smem_bytes(c0, c0 + nb * growth)]


def rdstb_kernel_supports(n: int, c0: int, growth: int, nb: int, nh: int,
                          hidden_ratio: float, int8: bool = False) -> bool:
    """Whether the RDSTB's stage kernels take this geometry: 1 to 4
    DSTLs, C0 <= ``CONV_MAX_C0`` for the conv's output tiles, each DSTL
    within the limits of its stage design (:func:`dstl_routes`: the
    window body's, ``window_body.body_supports``; the token-parallel
    forward's, ``token_kernel_supports``), and every stage's shared
    memory (:func:`rdstb_stage_smem_bytes`) within an H100 block's."""
    if not (1 <= nb <= MAX_DSTLS and 0 < c0 <= CONV_MAX_C0 and growth > 0):
        return False
    for d, route in enumerate(dstl_routes(c0, growth, nb, int8)):
        c = c0 + d * growth
        hidden = int(c * hidden_ratio)
        ok = (token_kernel_supports(n, c, nh, hidden, growth)
              if route == "tokens" else body_supports(n, c, nh, hidden))
        if not ok:
            return False
    smem = rdstb_stage_smem_bytes(n, c0, growth, nb, nh, hidden_ratio, int8)
    return all(0 < b <= H100_SMEM_OPTIN for b in smem)


def rdstb_kernel_count(routes: List[str], prenorm: bool, mask: int = 0,
                       conv: bool = False) -> int:
    """Kernels one call launches: per DSTL two on the window body, or a
    token-parallel forward a block (``token_fwd_kernels(mask)``: five,
    more with int8 'mlp' / 'proj') and the adapter's one (two pre-norm);
    then the conv, after its amax pass with int8 'conv'."""
    return 1 + int(conv) + sum(
        2 if r == "window" else 2 * token_fwd_kernels(mask) + 1
        + int(prenorm) for r in routes)


class RdstbPlan(NamedTuple):
    """An RDSTB's operands, prepared once (:func:`plan_rdstb`)."""
    dstls: List[PreppedDstl]
    wc: torch.Tensor     # (9*C_cat, C0) bf16 tap-major conv rows
    bc: torch.Tensor     # (C0,) f32
    growth: int
    prenorm: bool
    kernel_args: list    # the kernel's weight operands on CUDA, else []
    routes: List[str]    # each DSTL's stage design (dstl_routes)
    conv: Optional[ConvQuant] = None  # the conv's int8 operands, or None

    @property
    def int8_mask(self) -> int:
        """The blocks' int8 'mlp' / 'proj' flags (``int8_mask``)."""
        return self.dstls[0].int8_mask

    @property
    def int8_blocks(self) -> bool:
        """Whether the blocks run any int8 product."""
        d = self.dstls[0]
        return d.qa is not None or bool(d.int8_mask)


def _window_args(d: PreppedDstl, c: int, growth: int, nh: int) -> list:
    """A DSTL's operands on the window body: both blocks' panels (block
    b's followed by the adapter's) and fragment-ordered biases, the
    adapter's bias (ng) and post-norm LN scale and bias."""
    ad = d.adapter
    dev = ad.w.device
    wad = torch.zeros(growth, _round_up(c, 16), dtype=BF16, device=dev)
    wad[:, :c] = ad.w.t()
    bad = torch.zeros(_round_up(growth, 32), dtype=torch.float32,
                      device=dev)
    bad[:growth] = ad.b
    return [*stage_layout(kernel_layout(d.pa), c, nh),
            stage_bias(d.bias_a, nh),
            *stage_layout(kernel_layout(d.pb), c, nh, wad),
            stage_bias(d.bias_b, nh), bad, ad.gamma.contiguous(),
            ad.beta.contiguous()]


def _token_args(d: PreppedDstl, c: int, growth: int, nh: int) -> list:
    """A DSTL's operands on the token-parallel forward: per block its
    ``token_wgmma_layout``, packed bias, int8 qkv operands (0, 0 for bf16
    qkv) and int8 fc1 / fc2 / projection operands (``int8_token_layout``,
    0 for a group that is off); the adapter's (growth, c8) bf16 weight
    (the Dense transposed, zero past c), bias and post-norm LN scale and
    bias."""
    ad = d.adapter
    wad = torch.zeros(growth, _round_up(c, 8), dtype=BF16,
                      device=ad.w.device)
    wad[:, :c] = ad.w.t()
    out = []
    for p, bias, q in ((d.pa, d.bias_a, d.quant_a),
                       (d.pb, d.bias_b, d.quant_b)):
        out += [*token_wgmma_layout(token_layout(p, nh)), bias,
                *(qkv_token_layout(q.qkv, c, nh) or (0, 0)),
                *int8_token_layout(q.mlp, q.proj, c, p.w1.shape[1])]
    return out + [wad, ad.b.contiguous(), ad.gamma.contiguous(),
                  ad.beta.contiguous()]


def conv_panels_int8(wq, c0: int, ccat: int):
    """The int8 conv's (9*C_cat, C0) tap-major rows -> its panels: per
    N-piece of 64 output channels, per tap, per K-piece of 256 inputs,
    each tap's (out, in) = (C0 to 32, C_cat to 32) int8 weight in wgmma's
    core-matrix order for 8-bit operands (8 rows x 16 inputs
    contiguous)."""
    no, kq = _round_up(c0, 32), _round_up(ccat, 32)
    full = torch.zeros(9, no, kq, dtype=torch.int8, device=wq.device)
    full[:, :c0, :ccat] = wq.reshape(9, ccat, c0).permute(0, 2, 1)
    out = []
    for n0 in range(0, no, 64):
        for t in range(9):
            for k0 in range(0, kq, 256):
                piece = full[t, n0:n0 + 64, k0:k0 + 256]
                nn, kk = piece.shape
                out.append(piece.reshape(nn // 8, 8, kk // 16, 16)
                           .permute(0, 2, 1, 3).reshape(-1))
    return torch.cat(out)


def plan_rdstb(dstls, conv_kernel, conv_bias, *, num_heads: int,
               growth: int, adapter_prenorm: bool,
               quant=frozenset()) -> RdstbPlan:
    """Fold and lay out an RDSTB's weights (the JAX ``fused_rdstb``
    argument layout, see :func:`fused_rdstb`), with the int8 operands of
    every block for the groups of ``quant`` it holds ('qkv', 'mlp',
    'proj') and of the conv with 'conv'; on a CUDA device lay each DSTL
    out for its stage design (:func:`dstl_routes`) and the conv's weights
    as panels. Depends on the weights only, so a caller may keep it."""
    ccat, c0 = conv_kernel.shape[2], conv_kernel.shape[3]
    nb = len(dstls)
    if nb < 1 or ccat != c0 + nb * growth or tuple(conv_bias.shape) != (c0,):
        raise ValueError(f"{nb} DSTLs growing by {growth} from {c0} do not "
                         f"fit conv {tuple(conv_kernel.shape)} / "
                         f"{tuple(conv_bias.shape)}")
    groups = check_ported(quant)
    n = dstls[0]["blocks"][0][1].shape[-1]
    prepped = prep_dstls(dstls, c0, growth, num_heads, n, adapter_prenorm,
                         groups)
    routes = dstl_routes(c0, growth, nb, bool(groups))
    wc = conv_rows(conv_kernel)
    bc = conv_bias.to(torch.float32)
    cq = conv_quant(wc) if "conv" in frozenset(quant or ()) else None
    args = []
    if wc.device.type == "cuda":
        args = ([conv_panels(wc, c0, ccat), bc, 0] if cq is None else
                [conv_panels_int8(cq.wq, c0, ccat), bc, cq.ws.contiguous()])
        for i, (d, route) in enumerate(zip(prepped, routes)):
            make = _token_args if route == "tokens" else _window_args
            args += make(d, c0 + i * growth, growth, num_heads)
    return RdstbPlan(prepped, wc, bc, growth, bool(adapter_prenorm), args,
                     routes, cq)


def run_rdstb(x_tokens, plan: RdstbPlan, *, num_heads: int, x_size,
              window_size: int, shift: int, softmax: str = ""):
    """One whole RDSTB on bf16 image-major tokens (B, H*W, C0) with a
    prepared plan. A CPU tensor takes :func:`rdstb_reference`; a CUDA
    tensor launches the kernel or raises; geometry the kernel does not
    take raises on either device. The dynamic int8 scales are taken over
    the images of one JAX program (``quant.rdstb_group_images``)."""
    h, w = x_size
    ws = window_size
    nh = num_heads
    n = ws * ws
    if x_tokens.dim() != 3:
        raise ValueError(f"x_tokens must be (B, H*W, C0), got "
                         f"{tuple(x_tokens.shape)}")
    b, l, c0 = x_tokens.shape
    nb, growth = len(plan.dstls), plan.growth
    ratio = plan.dstls[0].pa.w1.shape[1] / c0
    code = softmax_code(softmax)
    int8 = plan.int8_blocks
    if (l != h * w or h % ws or w % ws or not 0 <= shift < ws
            or not rdstb_kernel_supports(n, c0, growth, nb, nh, ratio,
                                         int8)):
        raise ValueError(
            f"fused_rdstb: the CUDA kernel does not take {nb} DSTLs of "
            f"C0={c0} growing by {growth}, heads={nh}, MLP ratio {ratio}, "
            f"{'int8' if int8 else 'bf16'} block products, {h}x{w} with "
            f"window {ws} "
            f"and shift {shift} (needs 1-{MAX_DSTLS} DSTLs, C0 <= "
            f"{CONV_MAX_C0}, windows of 16 or 64 tokens, head dim <= 32, "
            f"widths <= {BODY_MAX_C} on the window body and <= {FAST_MAX_C}"
            " on the token-parallel stages, every stage within "
            f"{H100_SMEM_OPTIN} bytes of shared memory); build with "
            "pallas_kernels='pair' or 'off'")
    want = (plan.dstls[0].qa is not None, plan.int8_mask)
    if plan.routes != dstl_routes(c0, growth, nb, int8) or any(
            (q.qkv is not None, int8_mask(q.mlp, q.proj)) != want
            for d in plan.dstls for q in (d.quant_a, d.quant_b)):
        raise ValueError(f"plan routes {plan.routes} do not fit C0={c0} "
                         f"growing by {growth} with "
                         f"{'int8' if int8 else 'bf16'} block products")
    nw = (h // ws) * (w // ws)
    for i, d in enumerate(plan.dstls):
        c = c0 + i * growth
        if (d.pa.wqkv.shape[0] != c or d.pb.wqkv.shape[0] != c
                or d.pa.w1.shape[1] != int(c * ratio)
                or d.pb.w1.shape[1] != int(c * ratio)
                or tuple(d.bias_a.shape) != (1, n, nh * n)
                or tuple(d.bias_b.shape) != ((nw if shift else 1), n, nh * n)
                or tuple(d.adapter.w.shape) != (c, growth)):
            raise ValueError(f"DSTL {i}: the plan does not fit width {c}, "
                             f"{nh} heads, {nw} windows, shift {shift}")
    check_fast_tokens("x_tokens", x_tokens, (b, l, c0))
    dev = x_tokens.device
    if plan.wc.device != dev:
        raise ValueError(f"plan is on {plan.wc.device}, x_tokens on {dev}")
    gi = b
    if (plan.int8_mask or plan.conv is not None) and b:
        gi = rdstb_group_images(b, nw, n, c0, growth, nb, nh, ratio,
                                softmax=softmax)
    if dev.type == "cpu":
        return rdstb_reference(
            x_tokens, plan.dstls, plan.wc, plan.bc, num_heads=nh,
            x_size=x_size, window_size=ws, shift=shift, growth=growth,
            adapter_prenorm=plan.prenorm, softmax=softmax, conv=plan.conv,
            group_images=gi)
    out = torch.empty_like(x_tokens)
    if b == 0:
        return out
    c8 = _round_up(c0 + (nb - 1) * growth, 8)
    y = torch.empty(b * l * c8, dtype=BF16, device=dev)
    dense = torch.empty(b * l * _round_up(c0 + nb * growth, 16), dtype=BF16,
                        device=dev)
    dims = ([b, h, w, ws, shift, c0, growth, nb, nh, int(plan.prenorm),
             code] + [d.pa.w1.shape[1] for d in plan.dstls]
            + [int(r == "tokens") for r in plan.routes]
            + [gi, plan.int8_mask, int(plan.conv is not None)])
    lib = _build.load(_SOURCE)
    nwork = work_bytes(lib, "rdstb_work_bytes", dims)
    work = (torch.empty(nwork, dtype=torch.uint8, device=dev) if nwork
            else 0)
    launch(lib, "rdstb_bf16",
           [x_tokens, out, y, dense, work, *plan.kernel_args], dims, dev)
    run_rdstb.launches += 1
    run_rdstb.kernels += rdstb_kernel_count(plan.routes, plan.prenorm,
                                            plan.int8_mask,
                                            plan.conv is not None)
    return out


run_rdstb.launches = 0  # calls that launched, since the last reset
run_rdstb.kernels = 0   # stage kernels those calls launched


def fused_rdstb(x_tokens, dstls, conv_kernel, conv_bias, *,
                num_heads: int, x_size, window_size: int, shift: int,
                growth: int, adapter_prenorm: bool = False,
                softmax: str = "", quant=frozenset()):
    """One whole RDSTB on bf16 image-major tokens (B, H*W, C0), as the
    JAX function takes it.

    dstls: per DSTL ``{'blocks': [(params12, bias), (params12, bias)],
    'adapter': (wa, ba, gamma, beta)}`` in the JAX layout (block a
    unshifted with the shared (nH, N, N) bias, block b shifted; adapter
    Dense (C, growth)); conv_kernel (3, 3, C_cat, C0) HWIO; conv_bias
    (C0,); ``quant`` the int8 groups (any of 'qkv', 'mlp', 'proj',
    'conv').
    :func:`plan_rdstb`, then :func:`run_rdstb`."""
    plan = plan_rdstb(dstls, conv_kernel, conv_bias, num_heads=num_heads,
                      growth=growth, adapter_prenorm=adapter_prenorm,
                      quant=quant)
    return run_rdstb(x_tokens, plan, num_heads=num_heads, x_size=x_size,
                     window_size=window_size, shift=shift, softmax=softmax)
