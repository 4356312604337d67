"""A whole RDSTB in one call: the CUDA stage kernels and their plain
PyTorch versions.

Counterpart of ``rdst_tpu/kernels/rdstb_block.py::fused_rdstb`` (bf16 fast
branch only, as there). On image-major tokens (B, H*W, C0), per DSTL:
block a on the windows of the dense features, the shift relayout, block
b, the inverse relayout, the tail adapter (Dense C->growth then LN, or
with ``adapter_prenorm`` the LN(C) affine folded into the Dense), and the
dense concat; then the 3x3 conv from C0 + nb*growth channels back to C0
(weights tap-major (9*C_cat, C0), as ``_conv3x3``) and the residual.

:func:`fused_rdstb` prepares the weights (:func:`plan_rdstb`) and calls
:func:`run_rdstb`, which launches the 2*nb + 1 stage kernels of
``csrc/rdstb_block.cu`` for a CUDA tensor (per DSTL: stage A, block a
into an image-layout scratch; stage B, block b on the rolled windows,
the adapter, the growth channels into the dense rows; then the conv as a
tiled implicit GEMM) and counts the call in ``run_rdstb.launches`` and
its kernels in ``run_rdstb.kernels``; for a CPU tensor it computes
:func:`rdstb_reference`. :func:`rdstb_staged_reference` computes stage by
stage what the kernels compute, over their buffer layouts. What the
kernels do not take raises on either device. The JAX package's
``fused_rdstb_probe`` (a Mosaic compile probe that let a geometry fall
back quietly) has no counterpart: the port's gate is
:func:`rdstb_kernel_supports`, checked when the model is built and again
at every call, and a refusal raises.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch.nn import functional as F

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.swin_block import (
    BF16, H100_SMEM_OPTIN, FastParams, _EPS, _round_up, check_fast_tokens,
    fast_body, fast_kernel_supports, fast_params, fast_smem_bytes,
    kernel_layout, launch, normalize, pack_bias_fast, softmax_code)
from rdst_tpu_torch.kernels.swin_pair import (shift_relayout,
                                              unshift_relayout)
from rdst_tpu_torch.kernels.window_body import (conv_panels,
                                                conv_smem_bytes, make_geom,
                                                stage_bias, stage_fit,
                                                stage_layout, window_pixels)
from rdst_tpu_torch.nn.swin import window_partition, window_reverse

_SOURCE = "rdstb_block.cu"
MAX_DSTLS = 4  # DSTLs one launch takes (kMaxDstl in the CUDA source)


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
               prenorm: bool) -> List[PreppedDstl]:
    """Fold every DSTL's two blocks (``prep_block_params``), pack their
    biases and prepare the adapters."""
    out = []
    c = c0
    for d in dstls:
        (pa, bias_a), (pb, bias_b) = d["blocks"]
        out.append(PreppedDstl(
            fast_params(pa, c, nh), pack_bias_fast(bias_a, nh, n),
            fast_params(pb, c, nh), pack_bias_fast(bias_b, nh, n),
            prep_adapter(*d["adapter"], prenorm)))
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


def rdstb_reference(x_tokens, prepped: List[PreppedDstl], wc, bc, *,
                    num_heads: int, x_size, window_size: int, shift: int,
                    growth: int, adapter_prenorm: bool, softmax: str):
    """Plain PyTorch version of the RDSTB kernel: bf16 image-major tokens
    (B, H*W, C0), prepared DSTLs, tap-major bf16 conv rows (9*C_cat, C0)
    and the f32 conv bias; returns bf16 (B, H*W, C0)."""
    b, l, c0 = x_tokens.shape
    h, w = x_size
    ws = window_size
    x0 = x_tokens
    feats = [_image_to_windows(x0.reshape(b, h, w, c0), ws)]
    for d in prepped:
        xin = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        y = fast_body(xin.float(), d.pa, d.bias_a, num_heads=num_heads,
                      softmax=softmax).to(BF16)
        y = shift_relayout(y, x_size, ws, shift)
        y = fast_body(y.float(), d.pb, d.bias_b, num_heads=num_heads,
                      softmax=softmax).to(BF16)
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
    kern = wc.float().reshape(3, 3, ccat, c0).permute(3, 2, 0, 1)
    out = F.conv2d(img.permute(0, 3, 1, 2).float(), kern, padding=1)
    out = out.permute(0, 2, 3, 1).reshape(b, l, c0)
    return (out + bc.float() + x0.float()).to(BF16)


def rdstb_staged_reference(x_tokens, prepped: List[PreppedDstl], wc, bc,
                           *, num_heads: int, x_size, window_size: int,
                           shift: int, growth: int, adapter_prenorm: bool,
                           softmax: str):
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
    x0, bf16."""
    b, l, c0 = x_tokens.shape
    h, w = x_size
    ws = window_size
    nh = num_heads
    n = ws * ws
    nw = (h // ws) * (w // ws)
    nb = len(prepped)
    ccat = c0 + nb * growth
    ccatp = _round_up(ccat, 16)
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
                       softmax=softmax).to(BF16)
        y = torch.zeros(b, l, c8, dtype=BF16, device=dev)
        y[:, unshifted, :c] = ya.reshape(b, nw * n, c)
        rows = y[:, rolled, :c].reshape(b * nw, n, c)
        z = fast_body(rows.float(), d.pb, d.bias_b, num_heads=nh,
                      softmax=softmax).to(BF16).float()
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
    img = F.pad(dense.reshape(b, h, w, ccatp).float(), (0, 0, 1, 1, 1, 1))
    taps = torch.zeros(9, ccatp, c0, dtype=torch.float32, device=dev)
    taps[:, :ccat] = wc.float().reshape(9, ccat, c0)
    out = torch.zeros(b, h, w, c0, dtype=torch.float32, device=dev)
    for t in range(9):
        dy, dx = divmod(t, 3)
        out = out + img[:, dy:dy + h, dx:dx + w] @ taps[t]
    out = out.reshape(b, l, c0) + bc.float() + dense[..., :c0].float()
    return out.to(BF16)


def admission_smem_bytes(n: int, c0: int, growth: int, nb: int, nh: int,
                         hidden_ratio: float) -> int:
    """The shared memory :func:`rdstb_kernel_supports` admits by: what the
    one-window body of the first RDSTB kernel took (the widest DSTL's
    window with the adapter rows in its attention region, or the conv's
    (ws+2)^2 halo). The stage kernels keep this rule so that the gate
    admits exactly the geometries it admitted; their own shared memory is
    :func:`rdstb_smem_bytes`."""
    ws = int(round(n ** 0.5))
    need = 0
    for d in range(nb):
        c = c0 + d * growth
        hidden = int(c * hidden_ratio)
        total = fast_smem_bytes(n, c, nh, hidden)
        # the adapter's f32 rows start at the attention region
        cp = _round_up(c, 16)
        region = _round_up(4 * n * c, 16) + _round_up(2 * n * (cp + 8), 16)
        need = max(need, total, region + 4 * n * _round_up(growth, 8))
    ccp = _round_up(c0 + nb * growth, 16)
    return max(need, 2 * (ws + 2) ** 2 * (ccp + 8))


def rdstb_stage_smem_bytes(n: int, c0: int, growth: int, nb: int, nh: int,
                           hidden_ratio: float) -> List[int]:
    """Dynamic shared memory of each of a call's 2*nb + 1 stage kernels
    (``rdstb_stage_smem_bytes`` in the CUDA source), in launch order:
    per DSTL stage A and stage B (with the adapter's rows), then the
    conv; 0 for a stage whose window body does not fit."""
    out = []
    for d in range(nb):
        c = c0 + d * growth
        g = make_geom(n, c, nh, int(c * hidden_ratio))
        out += [stage_fit(g).smem, stage_fit(g, _round_up(growth, 32)).smem]
    return out + [conv_smem_bytes(c0, c0 + nb * growth)]


def rdstb_smem_bytes(n: int, c0: int, growth: int, nb: int, nh: int,
                     hidden_ratio: float) -> int:
    """The most dynamic shared memory any stage kernel of a call takes."""
    return max(rdstb_stage_smem_bytes(n, c0, growth, nb, nh, hidden_ratio))


def rdstb_kernel_supports(n: int, c0: int, growth: int, nb: int, nh: int,
                          hidden_ratio: float) -> bool:
    """Whether the RDSTB kernels take this geometry: 1 to 4 DSTLs whose
    widths the window body takes, C0 <= 128 for the conv's output tiles,
    and :func:`admission_smem_bytes` within an H100 block's."""
    if not (1 <= nb <= MAX_DSTLS and 0 < c0 <= 128 and growth > 0):
        return False
    smem = admission_smem_bytes(n, c0, growth, nb, nh, hidden_ratio)
    return smem <= H100_SMEM_OPTIN and all(
        fast_kernel_supports(n, c0 + d * growth, nh,
                             int((c0 + d * growth) * hidden_ratio), smem)
        for d in range(nb))


class RdstbPlan(NamedTuple):
    """An RDSTB's operands, prepared once (:func:`plan_rdstb`)."""
    dstls: List[PreppedDstl]
    wc: torch.Tensor     # (9*C_cat, C0) bf16 tap-major conv rows
    bc: torch.Tensor     # (C0,) f32
    growth: int
    prenorm: bool
    kernel_args: list    # the kernel's weight operands on CUDA, else []


def plan_rdstb(dstls, conv_kernel, conv_bias, *, num_heads: int,
               growth: int, adapter_prenorm: bool) -> RdstbPlan:
    """Fold and lay out an RDSTB's weights (the JAX ``fused_rdstb``
    argument layout, see :func:`fused_rdstb`). Depends on the weights
    only, so a caller may keep it."""
    ccat, c0 = conv_kernel.shape[2], conv_kernel.shape[3]
    nb = len(dstls)
    if nb < 1 or ccat != c0 + nb * growth or tuple(conv_bias.shape) != (c0,):
        raise ValueError(f"{nb} DSTLs growing by {growth} from {c0} do not "
                         f"fit conv {tuple(conv_kernel.shape)} / "
                         f"{tuple(conv_bias.shape)}")
    n = dstls[0]["blocks"][0][1].shape[-1]
    prepped = prep_dstls(dstls, c0, growth, num_heads, n, adapter_prenorm)
    wc = conv_rows(conv_kernel)
    bc = conv_bias.to(torch.float32)
    args = []
    dev = wc.device
    if dev.type == "cuda":
        ng = _round_up(growth, 32)
        args = [conv_panels(wc, c0, ccat), bc]
        for i, d in enumerate(prepped):
            c = c0 + i * growth
            ad = d.adapter
            wad = torch.zeros(growth, _round_up(c, 16), dtype=BF16,
                              device=dev)
            wad[:, :c] = ad.w.t()
            bad = torch.zeros(ng, dtype=torch.float32, device=dev)
            bad[:growth] = ad.b
            args += [*stage_layout(kernel_layout(d.pa), c, num_heads),
                     stage_bias(d.bias_a, num_heads),
                     *stage_layout(kernel_layout(d.pb), c, num_heads, wad),
                     stage_bias(d.bias_b, num_heads), bad,
                     ad.gamma.contiguous(), ad.beta.contiguous()]
    return RdstbPlan(prepped, wc, bc, growth, bool(adapter_prenorm), args)


def run_rdstb(x_tokens, plan: RdstbPlan, *, num_heads: int, x_size,
              window_size: int, shift: int, softmax: str = ""):
    """One whole RDSTB on bf16 image-major tokens (B, H*W, C0) with a
    prepared plan. A CPU tensor takes :func:`rdstb_reference`; a CUDA
    tensor launches the kernel or raises; geometry the kernel does not
    take raises on either device."""
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
    if (l != h * w or h % ws or w % ws or not 0 <= shift < ws
            or not rdstb_kernel_supports(n, c0, growth, nb, nh, ratio)):
        raise ValueError(
            f"fused_rdstb: the CUDA kernel does not take {nb} DSTLs of "
            f"C0={c0} growing by {growth}, heads={nh}, MLP ratio {ratio}, "
            f"{h}x{w} with window {ws} and shift {shift} (needs 1-"
            f"{MAX_DSTLS} DSTLs, windows of 16 or 64 tokens, widths <= 128,"
            " head dim <= 32 and the widest stage within "
            f"{H100_SMEM_OPTIN} bytes of shared memory); build with "
            "pallas_kernels='pair' or 'off'")
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
    if dev.type == "cpu":
        return rdstb_reference(
            x_tokens, plan.dstls, plan.wc, plan.bc, num_heads=nh,
            x_size=x_size, window_size=ws, shift=shift, growth=growth,
            adapter_prenorm=plan.prenorm, softmax=softmax)
    out = torch.empty_like(x_tokens)
    if b == 0:
        return out
    if not all(rdstb_stage_smem_bytes(n, c0, growth, nb, nh, ratio)):
        raise ValueError(f"fused_rdstb: a stage kernel's window body does "
                         f"not fit C0={c0} growing by {growth}, heads={nh} "
                         f"in {H100_SMEM_OPTIN} bytes")
    c8 = _round_up(c0 + (nb - 1) * growth, 8)
    y = torch.empty(b * l * c8, dtype=BF16, device=dev)
    dense = torch.empty(b * l * _round_up(c0 + nb * growth, 16), dtype=BF16,
                        device=dev)
    dims = [b, h, w, ws, shift, c0, growth, nb, nh, int(plan.prenorm),
            code] + [d.pa.w1.shape[1] for d in plan.dstls]
    launch(_build.load(_SOURCE), "rdstb_bf16",
           [x_tokens, out, y, dense, *plan.kernel_args], dims, dev)
    run_rdstb.launches += 1
    run_rdstb.kernels += 2 * nb + 1
    return out


run_rdstb.launches = 0  # calls that launched, since the last reset
run_rdstb.kernels = 0   # stage kernels those calls launched


def fused_rdstb(x_tokens, dstls, conv_kernel, conv_bias, *,
                num_heads: int, x_size, window_size: int, shift: int,
                growth: int, adapter_prenorm: bool = False,
                softmax: str = ""):
    """One whole RDSTB on bf16 image-major tokens (B, H*W, C0), as the
    JAX function takes it.

    dstls: per DSTL ``{'blocks': [(params12, bias), (params12, bias)],
    'adapter': (wa, ba, gamma, beta)}`` in the JAX layout (block a
    unshifted with the shared (nH, N, N) bias, block b shifted; adapter
    Dense (C, growth)); conv_kernel (3, 3, C_cat, C0) HWIO; conv_bias
    (C0,). :func:`plan_rdstb`, then :func:`run_rdstb`."""
    plan = plan_rdstb(dstls, conv_kernel, conv_bias, num_heads=num_heads,
                      growth=growth, adapter_prenorm=adapter_prenorm)
    return run_rdstb(x_tokens, plan, num_heads=num_heads, x_size=x_size,
                     window_size=window_size, shift=shift, softmax=softmax)
