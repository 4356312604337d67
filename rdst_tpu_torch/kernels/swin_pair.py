"""A DSTL's Swin block pair in one call: the CUDA stage kernels and their
plain PyTorch versions.

Counterpart of ``rdst_tpu/kernels/swin_block.py::fused_swin_pair`` (bf16
fast branch only, as there): block a (shift 0, shared bias) on
window-layout tokens, its output rounded to bf16, the relayout
window_reverse -> roll(-shift) -> window_partition (``_shift_relayout``),
then block b (shift, per-window bias); with ``quant`` (any of 'qkv',
'mlp', 'proj') each block's products of those groups on int8 operands
(``kernels.quant``), the dynamic scales of 'mlp' and 'proj' over the
windows of one JAX program (``quant.pair_group_windows``). The output
stays in the SHIFTED window layout: the caller's window_reverse +
roll(+shift) restores the image.

:func:`fused_swin_pair` prepares both blocks (``plan_fast_block`` with
the route :func:`~rdst_tpu_torch.kernels.swin_block.stage_route` picks
by width and int8: 'stage' for the window body, 'tokens' for the
token-parallel forward) and calls :func:`run_swin_pair`, which launches
the two stages of ``csrc/swin_pair.cu`` for a CUDA tensor -- stage A,
block a into an image-layout scratch; stage B, block b on the rolled
windows gathered from it; one kernel a stage on the window body, five to
eight on the token-parallel forward (``token_fwd_kernels``) -- and counts
the call in
``run_swin_pair.launches`` and its kernels in ``run_swin_pair.kernels``;
for a CPU tensor it computes :func:`swin_pair_reference`. What the
kernels do not take raises on either device.
:func:`swin_pair_staged_reference` computes stage by stage what the
kernels compute, with their scratch layout and gather.
"""

from __future__ import annotations

from typing import Optional

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.quant import (BlockQuant, QkvQuant,
                                          check_ported, pair_group_windows)
from rdst_tpu_torch.kernels.swin_block import (
    BF16, FAST_MAX_C, H100_SMEM_OPTIN, FastBlockPlan, check_fast_tokens,
    fast_body, launch, plan_fast_block, softmax_code, stage_route,
    token_fwd_kernels, token_kernel_supports, work_bytes)
from rdst_tpu_torch.kernels.window_body import (BODY_MAX_C, body_supports,
                                                make_geom, stage_fit,
                                                window_pixels)
from rdst_tpu_torch.nn.swin import window_partition, window_reverse

_SOURCE = "swin_pair.cu"
# kernels a call by stage design without int8 'mlp' / 'proj': one a stage
# on the window body, five (``tokfwd::fwd_kernels``) on the token-parallel
# forward
KERNELS = {"window": 2, "tokens": 10}
PLAN_ROUTE = {"window": "stage", "tokens": "tokens"}  # plan_fast_block's


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


def _int8(qkv: Optional[QkvQuant], quant: Optional[BlockQuant]) -> dict:
    """fast_body's int8 keywords: ``quant``'s groups, ``qkv`` over its."""
    q = quant or BlockQuant()
    return q._replace(qkv=qkv if qkv is not None else q.qkv)._asdict()


def swin_pair_reference(x_windows, pa, bias_a, pb, bias_b, *,
                        num_heads: int, x_size, window_size: int,
                        shift: int, softmax: str,
                        qkv_a: Optional[QkvQuant] = None,
                        qkv_b: Optional[QkvQuant] = None,
                        quant_a: Optional[BlockQuant] = None,
                        quant_b: Optional[BlockQuant] = None,
                        group_windows: Optional[int] = None):
    """Plain PyTorch version of the pair kernel: bf16 tokens in unshifted
    window layout, folded params (``FastParams``) and packed biases of
    both blocks, their int8 operands by group (``quant_a``, ``quant_b``;
    ``qkv_a``, ``qkv_b`` for the qkv group alone) and the windows of a
    scale group (:func:`fast_body`); returns bf16 tokens in shifted window
    layout."""
    gw = group_windows
    y = fast_body(x_windows.float(), pa, bias_a, num_heads=num_heads,
                  softmax=softmax, group_windows=gw, **_int8(qkv_a, quant_a))
    y2 = shift_relayout(y.to(BF16), x_size, window_size, shift)
    z = fast_body(y2.float(), pb, bias_b, num_heads=num_heads,
                  softmax=softmax, group_windows=gw, **_int8(qkv_b, quant_b))
    return z.to(BF16)


def swin_pair_staged_reference(x_windows, pa, bias_a, pb, bias_b, *,
                               num_heads: int, x_size, window_size: int,
                               shift: int, softmax: str,
                               qkv_a: Optional[QkvQuant] = None,
                               qkv_b: Optional[QkvQuant] = None,
                               quant_a: Optional[BlockQuant] = None,
                               quant_b: Optional[BlockQuant] = None,
                               group_windows: Optional[int] = None):
    """The pair's stage kernels in plain PyTorch (same arguments as
    :func:`swin_pair_reference`): stage A, block a on the unshifted
    windows, its bf16 rows written into the image-layout scratch (B, H*W,
    c8) at their pixels; stage B, each shifted window's rows gathered from
    the scratch by the kernels' index rule (:func:`window_pixels`), block
    b, bf16 rows in shifted window layout. Both stage designs compute
    this."""
    h, w = x_size
    ws = window_size
    t, n, c = x_windows.shape
    nw = (h // ws) * (w // ws)
    b = t // nw
    c8 = make_geom(n, c, num_heads, pa.w1.shape[1]).c8
    gw = group_windows
    ya = fast_body(x_windows.float(), pa, bias_a, num_heads=num_heads,
                   softmax=softmax, group_windows=gw,
                   **_int8(qkv_a, quant_a)).to(BF16)
    y = torch.zeros(b, h * w, c8, dtype=BF16, device=x_windows.device)
    y[:, window_pixels(h, w, ws, 0).reshape(-1), :c] = ya.reshape(
        b, nw * n, c)
    rows = y[:, window_pixels(h, w, ws, shift).reshape(-1), :c]
    z = fast_body(rows.reshape(t, n, c).float(), pb, bias_b,
                  num_heads=num_heads, softmax=softmax, group_windows=gw,
                  **_int8(qkv_b, quant_b))
    return z.to(BF16)


def pair_stage_smem_bytes(n: int, c: int, nh: int, hidden: int) -> int:
    """Dynamic shared memory of each of the pair's stage kernels on the
    window body (``swin_pair_smem_bytes``; 0 if the body does not fit)."""
    return stage_fit(make_geom(n, c, nh, hidden)).smem


def pair_design_supports(n: int, c: int, nh: int, hidden: int,
                         design: str) -> bool:
    """Whether the pair's stages in ``design`` take this block geometry:
    'window', the window body's limits and shared memory
    (:func:`pair_stage_smem_bytes`); 'tokens', the token-parallel
    forward's (``token_kernel_supports``)."""
    if design == "window":
        return (body_supports(n, c, nh, hidden)
                and 0 < pair_stage_smem_bytes(n, c, nh, hidden)
                <= H100_SMEM_OPTIN)
    return token_kernel_supports(n, c, nh, hidden)


def pair_kernel_supports(n: int, c: int, nh: int, hidden: int,
                         int8: bool = False) -> bool:
    """Whether the pair kernel takes this block geometry in the design
    :func:`stage_route` picks for its width and int8 products (any of
    'qkv', 'mlp', 'proj')."""
    return pair_design_supports(n, c, nh, hidden, stage_route(c, int8))


def plan_pair_block(params, bias, *, num_heads: int, quant=frozenset()):
    """One block of the pair, planned for the stage design of its width
    and int8 groups (:func:`stage_route`)."""
    int8 = bool(check_ported(quant))
    route = stage_route(params[0].shape[0], int8)
    return plan_fast_block(params, bias, num_heads=num_heads, quant=quant,
                           route=PLAN_ROUTE[route])


def run_swin_pair(x_windows, plan_a: FastBlockPlan, plan_b: FastBlockPlan,
                  *, num_heads: int, x_size, window_size: int, shift: int,
                  softmax: str = ""):
    """The pair on bf16 window-layout tokens (B*nW, N, C) with prepared
    plans of both blocks (block a's bias shared, block b's per window when
    shifted), both in one stage design: :func:`plan_pair_block` picks the
    route's, and a width both designs take may be planned for the other
    (``plan_fast_block`` with route 'stage' or 'tokens'). Returns (B*nW,
    N, C) in SHIFTED window layout. A CPU tensor takes
    :func:`swin_pair_reference`; a CUDA tensor launches the two stages or
    raises. The dynamic int8 scales are taken over the windows of one JAX
    program (``quant.pair_group_windows``)."""
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
    int8 = plan_a.quant.qkv is not None, plan_a.int8_mask
    route = {p: r for r, p in PLAN_ROUTE.items()}.get(plan_a.route)
    if (route is None or plan_b.route != plan_a.route
            or (plan_b.qkv is not None, plan_b.int8_mask) != int8):
        raise ValueError(
            f"fused_swin_pair runs both blocks in one stage design: plan "
            f"them with plan_pair_block (got routes {plan_a.route!r}, "
            f"{plan_b.route!r})")
    if (n != ws * ws or h % ws or w % ws or not 0 <= shift < ws
            or pb.w1.shape[-1] != hidden
            or not pair_design_supports(n, c, nh, hidden, route)):
        raise ValueError(
            f"fused_swin_pair: the CUDA kernel does not take N={n}, C={c}, "
            f"heads={nh}, hidden={hidden}, {h}x{w} with window {ws} and "
            f"shift {shift} (needs whole windows of 16 or 64 tokens, head "
            f"dim <= 32, C <= {BODY_MAX_C} on the window body with bf16 qkv "
            f"(its shared memory within {H100_SMEM_OPTIN} bytes), C <= "
            f"{FAST_MAX_C} on the token-parallel stages); build with "
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
    mask = plan_a.int8_mask
    gw = (pair_group_windows(t, nw, n, c, nh, hidden, softmax=softmax)
          if mask and t else t)
    if dev.type == "cpu":
        return swin_pair_reference(x_windows, pa, plan_a.bias, pb,
                                   plan_b.bias, num_heads=nh, x_size=x_size,
                                   window_size=ws, shift=shift,
                                   softmax=softmax, quant_a=plan_a.quant,
                                   quant_b=plan_b.quant, group_windows=gw)
    out = torch.empty_like(x_windows)
    if t == 0:
        return out
    c8 = make_geom(n, c, nh, hidden).c8
    scratch = torch.empty(t * n * c8, dtype=BF16, device=dev)
    lib = _build.load(_SOURCE)
    dims = [t // nw, h, w, ws, shift, c, nh, hidden, code]
    if route == "window":
        launch(lib, "swin_pair_bf16",
               [x_windows, out, scratch, *plan_a.layout, *plan_b.layout],
               dims, dev)
        run_swin_pair.kernels += KERNELS[route]
    else:
        dims += [gw, mask]
        work = torch.empty(work_bytes(lib, "swin_pair_tokens_work_bytes",
                                      dims), dtype=torch.uint8, device=dev)
        launch(lib, "swin_pair_tokens",
               [x_windows, out, scratch, *plan_a.token_ptrs(),
                *plan_b.token_ptrs(), work], dims, dev)
        run_swin_pair.kernels += 2 * token_fwd_kernels(mask)
    run_swin_pair.launches += 1
    return out


run_swin_pair.launches = 0  # calls that launched, since the last reset
run_swin_pair.kernels = 0   # stage kernels those calls launched


def fused_swin_pair(x_windows, params_a, bias_a, params_b, bias_b, *,
                    num_heads: int, x_size, window_size: int, shift: int,
                    softmax: str = "", quant=frozenset()):
    """One DSTL pair on bf16 window-layout tokens (B*nW, N, C), as the JAX
    function takes it: params_X the 12-param bundles of the two blocks
    (weights (in, out), LN affines), folded here; bias_a (nH, N, N);
    bias_b (nH*nW, N, N) when shifted, else (nH, N, N); ``quant`` the
    int8 groups (a subset of 'qkv', 'mlp', 'proj'; 'conv' is the RDSTB's
    and ignored). Returns (B*nW, N, C) in SHIFTED window layout
    (:func:`run_swin_pair`)."""
    return run_swin_pair(
        x_windows,
        plan_pair_block(params_a, bias_a, num_heads=num_heads, quant=quant),
        plan_pair_block(params_b, bias_b, num_heads=num_heads, quant=quant),
        num_heads=num_heads, x_size=x_size, window_size=window_size,
        shift=shift, softmax=softmax)
