"""A DSTL's Swin block pair in one call: the CUDA stage kernels and their
plain PyTorch versions.

Counterpart of ``rdst_tpu/kernels/swin_block.py::fused_swin_pair`` (bf16
fast branch only, as there): block a (shift 0, shared bias) on
window-layout tokens, its output rounded to bf16, the relayout
window_reverse -> roll(-shift) -> window_partition (``_shift_relayout``),
then block b (shift, per-window bias). The output stays in the SHIFTED
window layout: the caller's window_reverse + roll(+shift) restores the
image.

:func:`fused_swin_pair` prepares both blocks (``plan_fast_block`` with
route 'stage') and calls :func:`run_swin_pair`, which launches the two
stage kernels of ``csrc/swin_pair.cu`` for a CUDA tensor -- stage A,
block a into an image-layout scratch; stage B, block b on the rolled
windows gathered from it -- and counts the call in
``run_swin_pair.launches`` and its kernels in ``run_swin_pair.kernels``;
for a CPU tensor it computes :func:`swin_pair_reference`. What the
kernels do not take raises on either device.
:func:`swin_pair_staged_reference` computes stage by stage what the
kernels compute, with their scratch layout and gather.
"""

from __future__ import annotations

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.swin_block import (
    BF16, H100_SMEM_OPTIN, SHARED_MAX_C, FastBlockPlan, check_fast_tokens,
    fast_body, fast_kernel_supports, fast_smem_bytes, launch,
    plan_fast_block, softmax_code)
from rdst_tpu_torch.kernels.window_body import (make_geom, stage_fit,
                                                window_pixels)
from rdst_tpu_torch.nn.swin import window_partition, window_reverse

_SOURCE = "swin_pair.cu"
KERNELS = 2  # stage kernels a call (``swin_pair_kernels`` in the source)


def shift_relayout(y, x_size, window_size: int, shift: int):
    """``_shift_relayout``: window layout (B*nW, N, C) -> the window layout
    of the image rolled by (-shift, -shift)."""
    h, w = x_size
    ws = window_size
    c = y.shape[-1]
    img = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        img = torch.roll(img, (-shift, -shift), dims=(1, 2))
    return window_partition(img, ws).reshape(-1, ws * ws, c)


def unshift_relayout(y, x_size, window_size: int, shift: int):
    """``_unshift_relayout``: the inverse of :func:`shift_relayout`."""
    h, w = x_size
    ws = window_size
    c = y.shape[-1]
    img = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        img = torch.roll(img, (shift, shift), dims=(1, 2))
    return window_partition(img, ws).reshape(-1, ws * ws, c)


def swin_pair_reference(x_windows, pa, bias_a, pb, bias_b, *,
                        num_heads: int, x_size, window_size: int,
                        shift: int, softmax: str):
    """Plain PyTorch version of the pair kernel: bf16 tokens in unshifted
    window layout, folded params (``FastParams``) and packed biases of
    both blocks; returns bf16 tokens in shifted window layout."""
    y = fast_body(x_windows.float(), pa, bias_a, num_heads=num_heads,
                  softmax=softmax)
    y2 = shift_relayout(y.to(BF16), x_size, window_size, shift)
    z = fast_body(y2.float(), pb, bias_b, num_heads=num_heads,
                  softmax=softmax)
    return z.to(BF16)


def swin_pair_staged_reference(x_windows, pa, bias_a, pb, bias_b, *,
                               num_heads: int, x_size, window_size: int,
                               shift: int, softmax: str):
    """The pair's stage kernels in plain PyTorch (same arguments as
    :func:`swin_pair_reference`): stage A, block a on the unshifted
    windows, its bf16 rows written into the image-layout scratch (B, H*W,
    c8) at their pixels; stage B, each shifted window's rows gathered from
    the scratch by the kernels' index rule (:func:`window_pixels`), block
    b, bf16 rows in shifted window layout."""
    h, w = x_size
    ws = window_size
    t, n, c = x_windows.shape
    nw = (h // ws) * (w // ws)
    b = t // nw
    c8 = make_geom(n, c, num_heads, pa.w1.shape[1]).c8
    ya = fast_body(x_windows.float(), pa, bias_a, num_heads=num_heads,
                   softmax=softmax).to(BF16)
    y = torch.zeros(b, h * w, c8, dtype=BF16, device=x_windows.device)
    y[:, window_pixels(h, w, ws, 0).reshape(-1), :c] = ya.reshape(
        b, nw * n, c)
    rows = y[:, window_pixels(h, w, ws, shift).reshape(-1), :c]
    z = fast_body(rows.reshape(t, n, c).float(), pb, bias_b,
                  num_heads=num_heads, softmax=softmax)
    return z.to(BF16)


def pair_stage_smem_bytes(n: int, c: int, nh: int, hidden: int) -> int:
    """Dynamic shared memory of each of the pair's stage kernels
    (``swin_pair_smem_bytes``; 0 if the window body does not fit)."""
    return stage_fit(make_geom(n, c, nh, hidden)).smem


def run_swin_pair(x_windows, plan_a: FastBlockPlan, plan_b: FastBlockPlan,
                  *, num_heads: int, x_size, window_size: int, shift: int,
                  softmax: str = ""):
    """The pair on bf16 window-layout tokens (B*nW, N, C) with prepared
    plans of both blocks (block a's bias shared, block b's per window
    when shifted). Returns (B*nW, N, C) in SHIFTED window layout. A CPU
    tensor takes :func:`swin_pair_reference`; a CUDA tensor launches the
    two stage kernels or raises."""
    h, w = x_size
    ws = window_size
    nh = num_heads
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    pa, pb = plan_a.params, plan_b.params
    hidden = pa.w1.shape[-1]
    code = softmax_code(softmax)
    if (plan_a.route, plan_b.route) != ("stage", "stage"):
        raise ValueError("fused_swin_pair runs the stage kernels: plan both "
                         "blocks with plan_fast_block(..., route='stage')")
    if (n != ws * ws or h % ws or w % ws or not 0 <= shift < ws
            or pb.w1.shape[-1] != hidden
            or not fast_kernel_supports(n, c, nh, hidden)):
        raise ValueError(
            f"fused_swin_pair: the CUDA kernel does not take N={n}, C={c}, "
            f"heads={nh}, hidden={hidden}, {h}x{w} with window {ws} and "
            f"shift {shift} (needs whole windows of 16 or 64 tokens, C <= "
            f"{SHARED_MAX_C}, head dim <= 32 and {fast_smem_bytes(n, c, nh, hidden)} "
            f"<= {H100_SMEM_OPTIN} bytes of shared memory); build with "
            "pallas_kernels='swin' or 'off'")
    nw = (h // ws) * (w // ws)
    if t % nw:
        raise ValueError(f"{t} windows are not whole images of {nw}")
    if (tuple(plan_a.bias.shape) != (1, n, nh * n)
            or tuple(plan_b.bias.shape) != ((nw if shift else 1), n, nh * n)
            or pa.wqkv.shape[0] != c or pb.wqkv.shape[0] != c):
        raise ValueError(f"plans (C={pa.wqkv.shape[0]}, {pb.wqkv.shape[0]}; "
                         f"biases {tuple(plan_a.bias.shape)}, "
                         f"{tuple(plan_b.bias.shape)}) do not fit C={c}, "
                         f"{nh} heads, {nw} windows, shift {shift}")
    check_fast_tokens("x_windows", x_windows, (t, n, c))
    dev = x_windows.device
    if plan_a.bias.device != dev or plan_b.bias.device != dev:
        raise ValueError(f"plans are on {plan_a.bias.device}, x_windows on "
                         f"{dev}")
    if dev.type == "cpu":
        return swin_pair_reference(x_windows, pa, plan_a.bias, pb,
                                   plan_b.bias, num_heads=nh, x_size=x_size,
                                   window_size=ws, shift=shift,
                                   softmax=softmax)
    out = torch.empty_like(x_windows)
    if t == 0:
        return out
    if pair_stage_smem_bytes(n, c, nh, hidden) == 0:
        raise ValueError(f"fused_swin_pair: the stage kernels' window body "
                         f"does not fit N={n}, C={c}, heads={nh}, hidden="
                         f"{hidden} in {H100_SMEM_OPTIN} bytes")
    c8 = make_geom(n, c, nh, hidden).c8
    scratch = torch.empty(t * n * c8, dtype=BF16, device=dev)
    launch(_build.load(_SOURCE), "swin_pair_bf16",
           [x_windows, out, scratch, *plan_a.layout, *plan_b.layout],
           [t // nw, h, w, ws, shift, c, nh, hidden, code], dev)
    run_swin_pair.launches += 1
    run_swin_pair.kernels += KERNELS
    return out


run_swin_pair.launches = 0  # calls that launched, since the last reset
run_swin_pair.kernels = 0   # stage kernels those calls launched


def fused_swin_pair(x_windows, params_a, bias_a, params_b, bias_b, *,
                    num_heads: int, x_size, window_size: int, shift: int,
                    softmax: str = ""):
    """One DSTL pair on bf16 window-layout tokens (B*nW, N, C), as the JAX
    function takes it: params_X the 12-param bundles of the two blocks
    (weights (in, out), LN affines), folded here; bias_a (nH, N, N);
    bias_b (nH*nW, N, N) when shifted, else (nH, N, N). Returns (B*nW, N,
    C) in SHIFTED window layout (:func:`run_swin_pair`)."""
    return run_swin_pair(
        x_windows,
        plan_fast_block(params_a, bias_a, num_heads=num_heads,
                        route="stage"),
        plan_fast_block(params_b, bias_b, num_heads=num_heads,
                        route="stage"),
        num_heads=num_heads, x_size=x_size, window_size=window_size,
        shift=shift, softmax=softmax)
