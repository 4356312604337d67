"""Fused Swin transformer block: the CUDA kernels and their plain PyTorch
versions.

Counterpart of ``rdst_tpu/kernels/swin_block.py::fused_swin_block``: one
whole Swin block on window-layout tokens,

    LN1 -> qkv -> W-MSA (rel-pos bias + shift mask) -> proj -> +residual
        -> LN2 -> MLP (GELU) -> +residual,

with the same argument layout as the JAX function: weights (in, out),
LayerNorm affines (C,), and a head-major bias (nH*nW, N, N) per window
(shifted block) or (nH, N, N) shared by every window. It dispatches on
the dtype of the tokens, as the JAX function does (``use_fast_path``):

* float32 -> the precise branch (``_body`` with ``fast=False``):
  ``csrc/swin_block.cu``, six token-parallel kernels whose four
  projections run as 3xTF32 on the tensor cores, with the weights split
  once in a plan (:func:`plan_f32_block`, :func:`run_f32_block`), C up
  to ``F32_MAX_C`` (:func:`f32_kernel_supports`); plain version
  :func:`swin_block_reference`, and :func:`swin_block_staged_f32` for
  the kernel's phases at its split points;
* bfloat16 -> the fast branch (``fast=True``): LN affines and the q
  scale folded into the weights (:func:`prep_block_params`),
  normalize-only one-pass LayerNorm, a softmax stabilizer chosen by
  variant, approximate reciprocal, tanh GELU, bf16 roundings where the
  TPU kernel rounds, optionally int8 operands (``pallas_quant``: 'qkv',
  'mlp', 'proj', ``kernels.quant``; the dynamic scales of 'mlp' and
  'proj' over the windows of one JAX program):
  ``csrc/swin_block_fast.cu`` in one of two designs the plan picks by C
  and the int8 groups (:func:`fast_route`): the persistent window kernel
  on the window body of ``csrc/window_body.cuh`` (which the pair and
  RDSTB stage kernels run too) up to ``WINDOW_MAX_C`` without int8, the
  token-parallel forward (``csrc/token_fwd.cuh``, its GEMMs on
  ``csrc/token_wgmma.cuh``) above and for any int8 group; plain version
  :func:`swin_block_fast_reference`. It
  takes C up to ``FAST_MAX_C`` (SwinIR-std's 180, RDST-W96's 192); the
  train-pair kernels take what the window body takes
  (``kernels.pair_train``), and the pair and RDSTB stages take the design
  :func:`stage_route` picks.

Both count their launches, one a call whatever the kernels it runs
(``fused_swin_block.launches`` and ``run_fast_block.launches``). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises. What a kernel does not take raises on either device, so the CPU
path refuses what the card would; on the card nothing falls back to a
plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.quant import (QX, BlockQuant, MlpQuant,
                                          ProjQuant, QkvQuant, block_quant,
                                          int8_matmul, quant_dyn, quant_rows)

_EPS = 1e-5  # torch-default LayerNorm epsilon
_SOURCE = "swin_block.cu"
_MAX_HEAD_DIM = 32
H100_SMEM_OPTIN = 232448  # bytes of shared memory one block may opt into
# widest C of the fast block, its token-parallel forward and the
# single-block train kernels (``fastblk::kMaxC``), and of the train-pair
# kernels (``fastblk::kMaxCShared``)
FAST_MAX_C = 192
SHARED_MAX_C = 128
F32_MAX_C = 192  # widest C of the f32 block kernel (``kMaxC``)

# 'auto' picks clamp only when the checkpoint's stamped attn_logit_max
# clears this margin (kept equal to the JAX package's policy).
AUTO_CLAMP_MARGIN = 40.0


def resolve_softmax_auto(attn_logit_max) -> str:
    """``pallas_softmax='auto'`` policy: the clamp variant only for a
    checkpoint whose audited max attention logit clears the margin; an
    unstamped checkpoint gets the exact stable softmax ('stable_bc')."""
    if attn_logit_max is None:
        return "stable_bc"
    return ("clamp" if float(attn_logit_max) < AUTO_CLAMP_MARGIN
            else "stable_bc")


# The f32 kernel's tiles (csrc/swin_block.cu): 3xTF32 GEMM tiles of BM
# tokens x BN outputs over a 3-stage ring of kF32BK-deep A and weight
# slices (both TF32 parts), the accumulator tile parked for the epilogue.
_F32_BK, _F32_STAGES = 16, 3
_F32_TILES = ((64, 192), (64, 128), (64, 96), (64, 64), (128, 128),
              (128, 96), (128, 64))


def f32_tile_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one f32 GEMM tile (``Tile<BM, BN>::kSmem``)."""
    stage = bm * (_F32_BK + 4) + 2 * _F32_BK * (bn + 8)
    return 4 * max(_F32_STAGES * stage, bm * (bn + 4))


def f32_attn_smem_bytes(n: int, hd: int) -> int:
    """Shared memory of one (window, head) of the f32 attention
    (``attn_smem_bytes``): q^T, k^T, v and P^T in floats."""
    return 4 * (2 * hd * (n + 4) + n * _round_up(hd, 4) + n * (n + 4))


def f32_smem_bytes(n: int, c: int, nh: int) -> int:
    """The most shared memory a kernel of the f32 block takes: its
    widest GEMM tile or one (window, head) of its attention."""
    return max(max(f32_tile_smem_bytes(bm, bn) for bm, bn in _F32_TILES),
               f32_attn_smem_bytes(n, c // nh))


def f32_kernel_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the f32 block kernel (``csrc/swin_block.cu``, six
    token-parallel kernels) takes this block geometry: windows of N | 64
    tokens with N % 8 == 0, even C <= ``F32_MAX_C`` (its row kernels keep
    six values a lane), head dim <= 32, and its own tiles in an H100
    block's shared memory (:func:`f32_smem_bytes`): the limits
    ``dims_ok`` checks in the source. RDST-W96 (C up to 192) and
    SwinIR-std (C = 180) fit."""
    return (0 < n <= 64 and 64 % n == 0 and n % 8 == 0
            and 0 < c <= F32_MAX_C and c % 2 == 0 and nh > 0
            and c % nh == 0 and c // nh <= _MAX_HEAD_DIM and hidden > 0
            and f32_smem_bytes(n, c, nh) <= H100_SMEM_OPTIN)


def _layernorm(x, gamma, beta):
    """Two-pass LayerNorm (mean subtracted before the variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + _EPS) * gamma + beta


def _attention(qkv, bias, nh: int, windows_per_image: int,
               exp_floor: Optional[float] = None):
    """Per-head softmax attention of (T, N, 3C) q/k/v rows (q scaled) with
    the head-major bias (nH*bw or nH, N, N); ``exp_floor``: terms whose
    max-subtracted score is below it are 0 (the kernel's)."""
    t, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh

    def heads(u):
        return u.reshape(t, n, nh, hd).transpose(1, 2)

    q, k, v = heads(qkv[..., :c]), heads(qkv[..., c:2 * c]), \
        heads(qkv[..., 2 * c:])
    s = q @ k.transpose(-2, -1)  # (T, nH, N, N)
    if bias.shape[0] == nh:
        s = s + bias[None]
    else:
        bw = bias.shape[0] // nh
        if bw != windows_per_image:
            raise ValueError(f"bias {tuple(bias.shape)} is not per-window "
                             f"for {windows_per_image} windows")
        s = (s.reshape(t // bw, bw, nh, n, n)
             + bias.reshape(nh, bw, n, n).transpose(0, 1)[None]
             ).reshape(t, nh, n, n)
    if exp_floor is None:
        p = torch.softmax(s, dim=-1)
    else:
        d = s - s.amax(dim=-1, keepdim=True)
        e = torch.where(d < exp_floor, torch.zeros_like(d), torch.exp(d))
        p = e / e.sum(dim=-1, keepdim=True)
    return (p @ v).transpose(1, 2).reshape(t, n, c)


def _gelu_erf(h):
    return 0.5 * h * (1.0 + torch.erf(h * 2.0**-0.5))


def swin_block_reference(x_windows, wqkv, bqkv, wproj, bproj,
                         g1, b1, g2, b2, w1, bf1, w2, bf2, bias, *,
                         num_heads: int, windows_per_image: int):
    """Plain PyTorch version of the kernel (same arguments). x_windows:
    (B*nW, N, C); returns (B*nW, N, C)."""
    c = x_windows.shape[-1]
    hd = c // num_heads
    x = x_windows
    if bqkv is None:
        bqkv = x.new_zeros(3 * c)
    qkv = _layernorm(x, g1, b1) @ wqkv + bqkv
    qkv = torch.cat([qkv[..., :c] * hd**-0.5, qkv[..., c:]], dim=-1)
    o = _attention(qkv, bias, num_heads, windows_per_image)
    x1 = x + (o @ wproj + bproj)
    h1 = _gelu_erf(_layernorm(x1, g2, b2) @ w1 + bf1)
    return x1 + (h1 @ w2 + bf2)


_EXP_FLOOR = -80.0  # csrc/swin_block.cu kExpFloor


# The f32 kernel's split of an operand into two TF32 parts (3xTF32).
def tf32_round(x):
    """x (float32) rounded to TF32, 10 explicit mantissa bits, to nearest
    with ties away from zero (``cvt.rna.tf32.f32``), as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(big, small): big = tf32(x), small = tf32(x - big); big + small is
    x to about 2^-22 of |x|."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def mm3(a, big, small):
    """The kernel's 3xTF32 product a @ b from b's parts: a split as b is,
    small * big' + big * small' + big * big' (small * small' dropped),
    summed here in float64 and rounded to float32."""
    ab, as_ = (t.double() for t in tf32_split(a))
    bb, bs = big.double(), small.double()
    return ((as_ @ bb + ab @ bs) + ab @ bb).float()


def swin_block_staged_f32(x_windows, wqkv, bqkv, wproj, bproj,
                          g1, b1, g2, b2, w1, bf1, w2, bf2, bias, *,
                          num_heads: int, windows_per_image: int):
    """The f32 kernel's phases in plain PyTorch, at its split points: LN1;
    qkv as a 3xTF32 product, plus bias, q scaled; attention in f32 with
    the kernel's exp floor; proj (3xTF32) + residual, LN2; fc1 (3xTF32),
    erf GELU; fc2 (3xTF32) + residual. A second oracle beside
    :func:`swin_block_reference` (same arguments)."""
    c = x_windows.shape[-1]
    hd = c // num_heads
    x = x_windows.float()
    if bqkv is None:
        bqkv = x.new_zeros(3 * c)

    def mm(a, w):
        return mm3(a, *tf32_split(w))

    qkv = mm(_layernorm(x, g1, b1), wqkv) + bqkv
    qkv = torch.cat([qkv[..., :c] * hd**-0.5, qkv[..., c:]], dim=-1)
    o = _attention(qkv, bias, num_heads, windows_per_image, _EXP_FLOOR)
    x1 = x + (mm(o, wproj) + bproj)
    h1 = _gelu_erf(mm(_layernorm(x1, g2, b2), w1) + bf1)
    return x1 + (mm(h1, w2) + bf2)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def f32_kernel_layout(params):
    """The f32 kernel's operands of a 12-param bundle (JAX layout, bqkv
    not None): each weight (in, out) zero-padded to rows and columns of
    multiples of 8 -- wqkv (kp, n3), wproj (kp, kp), w1 (kp, hp), w2 (hp,
    kp) -- as its TF32 (big, small) parts; bqkv padded to n3; the other
    vectors as they are."""
    wqkv, bqkv, wproj, bproj, g1, b1, g2, b2, w1, bf1, w2, bf2 = params
    c, hidden = wproj.shape[0], w1.shape[1]
    kp, n3, hp = _round_up(c, 8), _round_up(3 * c, 8), _round_up(hidden, 8)

    def padded(w, rows, cols):
        out = w.new_zeros(rows, cols, dtype=torch.float32)
        out[:w.shape[0], :w.shape[1]] = w
        return tf32_split(out)

    bq = bqkv.new_zeros(n3, dtype=torch.float32)
    bq[:3 * c] = bqkv
    return (*padded(wqkv, kp, n3), bq, *padded(wproj, kp, kp), bproj,
            g1, b1, g2, b2, *padded(w1, kp, hp), bf1,
            *padded(w2, hp, kp), bf2)


def _lib():
    return _build.load(_SOURCE)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x_windows on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class F32BlockPlan(NamedTuple):
    """One block's f32 operands, prepared once (:func:`plan_f32_block`)."""
    params: tuple        # the 12 weights (JAX layout), bqkv never None
    bias: torch.Tensor   # head-major (nH*bw, N, N) float32
    layout: tuple        # f32_kernel_layout(params) on a CUDA device, else ()


def plan_f32_block(params, bias, *, num_heads: int) -> F32BlockPlan:
    """Check a block's 12-param bundle (JAX layout) and head-major bias
    against what the f32 route takes; on a CUDA device split the weights
    for the kernel (:func:`f32_kernel_layout`). Depends on the weights
    only, so a caller may keep it."""
    wqkv, bqkv, wproj, bproj, g1, b1, g2, b2, w1, bf1, w2, bf2 = params
    c, nh = wqkv.shape[0], num_heads
    hidden = w1.shape[-1]
    if bias.dim() != 3 or bias.shape[0] % nh or bias.shape[1] != bias.shape[2]:
        raise ValueError(f"bias must be head-major (nH*bw, N, N), got "
                         f"{tuple(bias.shape)}")
    n = bias.shape[1]
    if not f32_kernel_supports(n, c, nh, hidden):
        raise ValueError(
            f"fused_swin_block: the CUDA kernel does not take N={n}, C={c}, "
            f"heads={nh}, hidden={hidden} (the f32 kernel takes N | 64 with "
            f"N % 8 == 0, even C <= {F32_MAX_C} and head dim <= "
            f"{_MAX_HEAD_DIM})")
    dev = bias.device
    if bqkv is None:
        bqkv = torch.zeros(3 * c, device=dev, dtype=torch.float32)
    params = (wqkv, bqkv, wproj, bproj, g1, b1, g2, b2, w1, bf1, w2, bf2)
    shapes = ((c, 3 * c), (3 * c,), (c, c), (c,), (c,), (c,), (c,), (c,),
              (c, hidden), (hidden,), (hidden, c), (c,))
    names = ("wqkv", "bqkv", "wproj", "bproj", "g1", "b1", "g2", "b2", "w1",
             "bf1", "w2", "bf2")
    for name, tensor, shape in zip(names, params, shapes):
        _check(name, tensor, shape, dev)
    _check("bias", bias, bias.shape, dev)
    return F32BlockPlan(params, bias, f32_kernel_layout(params)
                        if dev.type == "cuda" else ())


def run_f32_block(x_windows, plan: F32BlockPlan, *, num_heads: int,
                  windows_per_image: int):
    """The f32 block on window-layout tokens (B*nW, N, C) with a prepared
    plan. A CPU tensor takes :func:`swin_block_reference`; a CUDA tensor
    launches ``csrc/swin_block.cu`` (six token-parallel kernels, one
    count in ``fused_swin_block.launches``) or raises."""
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    nh, nw = num_heads, windows_per_image
    hidden = plan.params[8].shape[-1]
    bias = plan.bias
    if plan.params[0].shape[0] != c or bias.shape[1] != n:
        raise ValueError(f"plan for C={plan.params[0].shape[0]}, N="
                         f"{bias.shape[1]} does not fit N={n}, C={c}")
    if bias.shape[0] not in (nh, nh * nw):
        raise ValueError(f"bias must be ({nh}*{nw} or {nh}, {n}, {n}), got "
                         f"{tuple(bias.shape)}")
    bias_windows = bias.shape[0] // nh
    if t % bias_windows:
        raise ValueError(f"{t} windows are not whole images of {nw}")
    dev = x_windows.device
    _check("x_windows", x_windows, (t, n, c), bias.device)
    if dev.type == "cpu":
        return swin_block_reference(x_windows, *plan.params, bias,
                                    num_heads=nh, windows_per_image=nw)
    if dev.type != "cuda":
        raise ValueError(f"fused_swin_block: unsupported device {dev}")
    out = torch.empty_like(x_windows)
    if t == 0:
        return out
    lib = _lib()
    dims = [t, n, c, nh, hidden, bias_windows]
    work = torch.empty(work_bytes(lib, "swin_block_f32_work_bytes", dims),
                       dtype=torch.uint8, device=dev)
    launch(lib, "swin_block_f32",
           [x_windows, out, *plan.layout, bias, work], dims, dev,
           errors="swin_block_error_string")
    fused_swin_block.launches += 1
    return out


def fused_swin_block(x_windows, wqkv, bqkv, wproj, bproj,
                     g1, b1, g2, b2, w1, bf1, w2, bf2, bias, *,
                     num_heads: int, windows_per_image: int,
                     softmax: str = ""):
    """Whole Swin block on window-layout tokens (B*nW, N, C).

    bfloat16 tokens take the fast branch (:func:`plan_fast_block`, then
    :func:`run_fast_block`, with the softmax variant ``softmax``);
    float32 tokens the precise branch (:func:`plan_f32_block`, then
    :func:`run_f32_block`). Arguments the CUDA kernels do not take raise
    on every device. Then a CPU tensor takes the plain version, and a
    CUDA tensor launches the CUDA kernel or raises."""
    params = (wqkv, bqkv, wproj, bproj, g1, b1, g2, b2, w1, bf1, w2, bf2)
    if x_windows.dtype == torch.bfloat16:
        plan = plan_fast_block(params, bias, num_heads=num_heads)
        return run_fast_block(x_windows, plan, num_heads=num_heads,
                              windows_per_image=windows_per_image,
                              softmax=softmax)
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    return run_f32_block(x_windows,
                         plan_f32_block(params, bias, num_heads=num_heads),
                         num_heads=num_heads,
                         windows_per_image=windows_per_image)


fused_swin_block.launches = 0  # kernel launches since the last reset


# --------------------------------------------------------------------------
# bfloat16 fast branch (``_body`` with ``fast=True``)
# --------------------------------------------------------------------------

BF16 = torch.bfloat16
_CLAMP = 60.0  # 'clamp' variant: exp(min(s, 60)), no max subtracted
_FAST_SOURCE = "swin_block_fast.cu"
# softmax variant -> the kernels' code. '' and 'stable' (per-head row max
# subtracted segment by segment) and 'stable_bc' (the same maxes broadcast
# first) give the same numbers; 'stable_mm' rounds the max to bf16 first.
SOFTMAX_CODES = {"": 0, "stable": 0, "stable_bc": 0, "clamp": 1,
                 "stable_mm": 2}


class FastParams(NamedTuple):
    """One block's folded fast-branch weights (:func:`fast_params`)."""
    wqkv: torch.Tensor   # (C, 3C) bf16: g1 * W * qscale
    bqkv: torch.Tensor   # (3C,) f32: (b1 @ W + b) * qscale
    wproj: torch.Tensor  # (C, C) bf16
    bproj: torch.Tensor  # (C,) bf16
    w1: torch.Tensor     # (C, H) bf16: g2 * W1
    bf1: torch.Tensor    # (H,) f32: b2 @ W1 + b
    w2: torch.Tensor     # (H, C) bf16
    bf2: torch.Tensor    # (C,) bf16


def softmax_code(variant: str) -> int:
    """The kernels' code of a resolved softmax variant ('auto' must be
    resolved against the checkpoint first); raises on anything else."""
    if variant not in SOFTMAX_CODES:
        raise ValueError(f"softmax variant {variant!r}: expected one of "
                         f"{sorted(SOFTMAX_CODES)} ('auto' is resolved "
                         "when the model is built)")
    return SOFTMAX_CODES[variant]


def fold_fast_weights(wqkv, bqkv, g1, b1, g2, b2, w1, bf1, c: int,
                      scale: float, dt=BF16):
    """``_fold_fast_weights``: LN1's affine and the q scale into
    wqkv/bqkv, LN2's affine into w1/bf1, (x^ g + b)W + c = x^ (g W) +
    (bW + c). Folded weights are rounded to ``dt``; folded biases stay
    float32."""
    f32 = torch.float32
    qs = torch.cat([torch.full((c,), scale, dtype=f32, device=wqkv.device),
                    torch.ones(2 * c, dtype=f32, device=wqkv.device)])
    wqkv_f = g1.to(f32)[:, None] * wqkv.to(f32) * qs[None]
    bqkv_f = (b1.to(f32) @ wqkv.to(f32) + bqkv.to(f32)) * qs
    w1_f = g2.to(f32)[:, None] * w1.to(f32)
    bf1_f = b2.to(f32) @ w1.to(f32) + bf1.to(f32)
    return wqkv_f.to(dt), bqkv_f, w1_f.to(dt), bf1_f


def prep_block_params(params, c: int, nh: int, dt=BF16):
    """``prep_block_params``: the 12-param bundle (JAX layout, weights
    (in, out)) cast and folded in the JAX package's order -- wqkv, bqkv,
    w1, bf1 rounded to ``dt`` first, then folded, the folded weights
    rounded again. Returns the same 12-list with the same shapes."""
    wqkv, bqkv, wproj, bproj, g1, b1, g2, b2, w1, bf1, w2, bf2 = params
    if bqkv is None:
        bqkv = torch.zeros(3 * c, dtype=wqkv.dtype, device=wqkv.device)
    wqkv, bqkv, w1, bf1 = (a.to(dt) for a in (wqkv, bqkv, w1, bf1))
    scale = (c // nh) ** -0.5
    wqkv, bqkv, w1, bf1 = fold_fast_weights(
        wqkv, bqkv, g1, b1, g2, b2, w1, bf1, c, scale, dt)
    hid = w1.shape[1]
    return [wqkv.to(dt), bqkv.reshape(1, 3 * c),
            wproj.to(dt), bproj.to(dt).reshape(1, c),
            g1.reshape(1, c), b1.reshape(1, c),
            g2.reshape(1, c), b2.reshape(1, c),
            w1.to(dt), bf1.reshape(1, hid),
            w2.to(dt), bf2.to(dt).reshape(1, c)]


def fast_params(params, c: int, nh: int) -> FastParams:
    """:func:`prep_block_params` reduced to what the fast body reads
    (the LN rows are folded away), biases flat."""
    p = prep_block_params(params, c, nh)
    return FastParams(p[0], p[1].reshape(-1), p[2], p[3].reshape(-1),
                      p[8], p[9].reshape(-1), p[10], p[11].reshape(-1))


def pack_bias_fast(bias, nh: int, n: int, dt=BF16):
    """Head-major (nH*bw, N, N) -> fast layout (bw, N, nH*N)."""
    bwin = bias.shape[0] // nh
    out = bias.reshape(nh, bwin, n, n).permute(1, 2, 0, 3)
    return out.reshape(bwin, n, nh * n).to(dt).contiguous()


def _bf(t):
    return t.to(BF16)


def _mm(a, b):
    """bf16 operands, float32 products and accumulation (the kernels'
    ``preferred_element_type=float32``)."""
    return a.float() @ b.float()


def normalize(xf):
    """``_normalize``: affine-free LayerNorm, one-pass moments
    ``var = max(E[x^2] - E[x]^2, 0)``, eps 1e-5, float32."""
    mu = xf.mean(dim=-1, keepdim=True)
    ex2 = (xf * xf).mean(dim=-1, keepdim=True)
    a = torch.rsqrt(torch.clamp(ex2 - mu * mu, min=0.0) + _EPS)
    return xf * a - mu * a


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)``."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def fast_attention(q, k, v, bias, code: int):
    """The fast branch's attention on bf16 q, k, v (T, nH, N, hd) with the
    packed (bw, N, nH*N) bf16 bias: s = q k^T + bias (float32), e =
    bf16(exp(...)) by softmax variant ``code``, o = (e v) / bf16(sum e)
    with an exact division; returns o (T, nH, N, hd) float32."""
    t, nh, n, _ = q.shape
    s = _mm(q, k.transpose(-2, -1))  # (T, nH, N, N) f32
    bw = bias.shape[0]
    bh = bias.float().reshape(bw, n, nh, n).permute(0, 2, 1, 3)
    s = (s.reshape(t // bw, bw, nh, n, n) + bh[None]).reshape(t, nh, n, n)
    if code == SOFTMAX_CODES["clamp"]:
        e = torch.exp(torch.clamp(s, max=_CLAMP))
    else:
        m = s.amax(dim=-1, keepdim=True)
        if code == SOFTMAX_CODES["stable_mm"]:
            m = _bf(m).float()  # the max broadcast through a bf16 product
        e = torch.exp(s - m)
    e = _bf(e)
    den = _bf(e.float().sum(dim=-1, keepdim=True)).float()
    return _mm(e, v) / den


def fast_body(xf, p: FastParams, bias, *, num_heads: int, softmax: str,
              dpf=None, qkv: Optional[QkvQuant] = None,
              mlp: Optional[MlpQuant] = None,
              proj: Optional[ProjQuant] = None,
              group_windows: Optional[int] = None):
    """The fast block body on float32 tokens (T, N, C) with its bf16
    roundings, as ``_body(fast=True)`` computes it; returns float32.

    ``bias`` is the packed (bw, N, nH*N) bf16 bias, bw = 1 (shared) or
    the bias period in windows. The softmax normalizer is an exact
    division here (the inference kernels use an approximate reciprocal;
    the training kernel divides exactly, as ``exact_recip=True``).
    ``dpf``: optional (attn, mlp) stochastic-depth factor columns, each
    (T*N,) float32, that scale the two residual branches (``_body``'s
    ``dpf``). int8 operands (``kernels.quant``): ``qkv``, the float32
    normalized rows quantized (not their bf16 rounding) and q, k, v =
    bf16(int32(xq @ wq) * ws + bqkv); ``proj``, the float32 attention
    output quantized at a dynamic scale, y = int32(oq @ wq) * (ws * dq) +
    bproj; ``mlp``, fc1 on LN2's float32 rows at the static step, h1 =
    gelu_tanh(int32 * w1s + bf1) in float32, quantized at a dynamic scale
    for fc2, int32 * (w2s * dq) + bf2. A dynamic scale is taken over each
    run of ``group_windows`` windows (one JAX program; None: all T).
    Differentiable with ``torch.autograd`` (without int8)."""
    code = softmax_code(softmax)
    t, n, c = xf.shape
    gw = t if group_windows is None else group_windows
    if gw <= 0 or t % gw:
        raise ValueError(f"{t} windows are not whole scale groups of {gw}")
    groups = t // gw

    def dyn(v):  # (T, N, K) float32 -> int8 rows, dequant step per window
        vq, dq = quant_dyn(v, groups)
        return vq, dq.repeat_interleave(gw).reshape(t, 1, 1)
    nh = num_heads
    hd = c // nh
    if qkv is None:
        xn = _bf(normalize(xf))

        def part(i):
            return _bf(_mm(xn, p.wqkv[:, i * c:(i + 1) * c])
                       + p.bqkv[i * c:(i + 1) * c])
    else:
        xq = quant_rows(normalize(xf), QX)

        def part(i):
            cols = slice(i * c, (i + 1) * c)
            return _bf(int8_matmul(xq, qkv.wq[:, cols]) * qkv.ws[cols]
                       + p.bqkv[cols])

    def heads(u):  # (T, N, C) -> (T, nH, N, hd)
        return u.reshape(t, n, nh, hd).transpose(1, 2)

    o = fast_attention(heads(part(0)), heads(part(1)), heads(part(2)), bias,
                       code)
    o = o.transpose(1, 2).reshape(t, n, c)
    if proj is None:
        y = _mm(_bf(o), p.wproj) + p.bproj.float()
    else:
        oq, dq = dyn(o)
        y = int8_matmul(oq, proj.wq) * (proj.ws * dq) + p.bproj.float()
    if dpf is not None:
        y = y * dpf[0].reshape(t, n, 1)
    x1 = xf + y
    if mlp is None:
        h1 = _bf(gelu_tanh(_mm(_bf(normalize(x1)), p.w1) + p.bf1))
        h2 = _mm(h1, p.w2) + p.bf2.float()
    else:
        x1q = quant_rows(normalize(x1), QX)
        h1 = gelu_tanh(int8_matmul(x1q, mlp.w1q) * mlp.w1s + p.bf1)
        h1q, dq = dyn(h1)
        h2 = int8_matmul(h1q, mlp.w2q) * (mlp.w2s * dq) + p.bf2.float()
    if dpf is not None:
        h2 = h2 * dpf[1].reshape(t, n, 1)
    return x1 + h2


def swin_block_fast_reference(x_windows, p: FastParams, bias, *,
                              num_heads: int, softmax: str,
                              qkv: Optional[QkvQuant] = None,
                              mlp: Optional[MlpQuant] = None,
                              proj: Optional[ProjQuant] = None,
                              group_windows: Optional[int] = None):
    """Plain PyTorch version of the fast block kernel: bf16 tokens
    (B*nW, N, C), folded params, packed bias, optional int8 operands of
    each group and the windows of a scale group (:func:`fast_body`);
    returns bf16."""
    return _bf(fast_body(x_windows.float(), p, bias, num_heads=num_heads,
                         softmax=softmax, qkv=qkv, mlp=mlp, proj=proj,
                         group_windows=group_windows))


def fast_smem_bytes(n: int, c: int, nh: int, hidden: int) -> int:
    """One window's working set in shared memory, as the first fast-block
    design (one window a thread block) laid it out: x rows f32; the LN /
    attention-output rows (bf16, stride cp + 8); q and k with each head
    padded to 8 channels, v transposed and padded to 8, all bf16, sharing
    their region with the MLP hidden rows. No kernel lays it out any
    more; it stays the bound :func:`fast_kernel_supports` admits by."""
    cp, hp = _round_up(c, 16), _round_up(hidden, 16)
    hd = c // nh
    hdq = hdv = _round_up(hd, 8)
    xs = _round_up(4 * n * c, 16)
    xn = _round_up(2 * n * (cp + 8), 16)
    attn = 2 * (2 * n * (nh * hdq + 8) + nh * hdv * (n + 8))
    mlp = 2 * n * (hp + 8)
    return xs + xn + _round_up(max(attn, mlp), 16)


def fast_kernel_supports(n: int, c: int, nh: int, hidden: int,
                         smem: Optional[int] = None,
                         max_c: int = SHARED_MAX_C) -> bool:
    """Whether the fast-branch CUDA kernels take this block geometry:
    N a multiple of 16 up to 64 (windows of 4 or 8), head dim <= 32,
    C <= ``max_c`` (``FAST_MAX_C`` for the fast block, its token-parallel
    forward and the single-block train kernels; ``SHARED_MAX_C`` by
    default), and ``smem`` (by default :func:`fast_smem_bytes`) in an
    H100 block's shared memory."""
    smem = fast_smem_bytes(n, c, nh, hidden) if smem is None else smem
    return (0 < n <= 64 and n % 16 == 0 and 0 < c <= max_c and nh > 0
            and c % nh == 0 and c // nh <= 32 and 0 < hidden <= 512
            and smem <= H100_SMEM_OPTIN)


def kernel_layout(p: FastParams, dtypes=(BF16, torch.float32)):
    """The CUDA kernels' weight layout: each weight transposed to
    (out, in) and zero-padded to multiples of 16 (qkv as three (cp, cp)
    parts), biases zero-padded. Pads are zero, so padded channels come
    out zero. ``dtypes``: of the bf16 arrays and of the f32 ones (an index
    map of the layout, ``kernels.pair_train``, passes integer
    tensors)."""
    c, hidden = p.wproj.shape[0], p.w1.shape[1]
    cp, hp = _round_up(c, 16), _round_up(hidden, 16)
    dev = p.wqkv.device
    wdt, fdt = dtypes

    def z(*shape, dtype=wdt):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    wqkv = z(3, cp, cp)
    wqkv[:, :c, :c] = p.wqkv.reshape(c, 3, c).permute(1, 2, 0)
    bqkv = z(3, cp, dtype=fdt)
    bqkv[:, :c] = p.bqkv.reshape(3, c)
    wproj = z(cp, cp)
    wproj[:c, :c] = p.wproj.t()
    bproj = z(cp)
    bproj[:c] = p.bproj
    w1 = z(hp, cp)
    w1[:hidden, :c] = p.w1.t()
    bf1 = z(hp, dtype=fdt)
    bf1[:hidden] = p.bf1
    w2 = z(cp, hp)
    w2[:c, :hidden] = p.w2.t()
    bf2 = z(cp)
    bf2[:c] = p.bf2
    return (wqkv.reshape(3 * cp, cp), bqkv.reshape(-1), wproj, bproj, w1,
            bf1, w2, bf2)


def launch(lib, entry: str, ptrs, dims, device,
           errors: str = "fast_error_string") -> None:
    """Call a kernel entry ``int entry(const void* const* ptrs, const int*
    dims, int device, void* stream)`` on the current stream and raise on
    a non-zero cudaError_t (named by the library's ``errors`` function).
    A pointer given as an int is passed as it is (0 for none)."""
    fn = getattr(lib, entry)
    if not getattr(fn, "_rdst_typed", False):
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._rdst_typed = True
    err_fn = getattr(lib, errors)
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    vals = [t if isinstance(t, int) else t.data_ptr() for t in ptrs]
    arr = (ctypes.c_void_p * len(vals))(*vals)
    dim = (ctypes.c_int * len(dims))(*[int(d) for d in dims])
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(arr, dim, index, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{err_fn(err).decode()} (error {err})")


def work_bytes(lib, entry: str, dims) -> int:
    """A kernel's workspace in bytes: ``long long entry(const int*
    dims)``."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    return int(fn((ctypes.c_int * len(dims))(*[int(d) for d in dims])))


def kernels_per_call(source: str, entry: str) -> int:
    """Kernels one call of a multi-kernel entry launches (``int
    entry()``), for measurements."""
    fn = getattr(_build.load(source), entry)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return int(fn())


def check_fast_tokens(name: str, x, shape) -> None:
    """Device-independent checks of a bf16 token tensor."""
    if x.dtype != BF16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


# The fast block's two designs (csrc/swin_block_fast.cu): "window", the
# persistent window kernel on the window body (csrc/window_body.cuh: two
# warpgroups a thread block taking the tensor cores in turns, weights
# resident where they fit), and "tokens", the token-parallel forward
# (csrc/token_fwd.cuh). The plan takes the window kernel up to this width
# without int8, where the window body beats the token-parallel forward on
# an H100 (both are timed in chip_smoke.py phase 7; PERF.md section 6),
# and the token-parallel forward above it (SwinIR-std's C = 180, phase 14)
# and for any int8 group ('qkv', 'mlp', 'proj'): the window body has no
# int8 product, and a dynamic scale needs a pass over the whole group
# between two products, which one persistent window kernel cannot give.
WINDOW_MAX_C = 120


def fast_route(c: int, int8: bool = False) -> str:
    """The fast block's design at width c: 'window' up to
    ``WINDOW_MAX_C`` without int8 products, else 'tokens'
    (:func:`stage_route`'s rule)."""
    return stage_route(c, int8)


# The window kernel's narrowest instantiation: its output columns come in
# NT = no / 32 pieces of 32 (``launch_window<NT>``), and at one piece (C <=
# 32) ptxas serializes its wgmma (C7515), so it is not built; the
# token-parallel forward takes those widths.
WINDOW_MIN_NO = 64


def window_kernel_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the persistent window kernel takes this geometry: the
    window body's (``window_body.body_supports``: windows of 16 or 64
    tokens), ``WINDOW_MIN_NO`` output columns or more (C > 32), C <=
    ``WINDOW_MAX_C``, and its plan in an H100 block's shared memory
    (``window_body.persist_fit``)."""
    from rdst_tpu_torch.kernels import window_body as wb

    if not (c <= WINDOW_MAX_C and wb.body_supports(n, c, nh, hidden)):
        return False
    g = wb.make_geom(n, c, nh, hidden)
    return g.no >= WINDOW_MIN_NO and wb.persist_fit(g).smem > 0


def stage_route(c: int, int8: bool) -> str:
    """The design of a pair or RDSTB stage at width c: 'window' (the
    stage kernels on ``csrc/window_body.cuh``) up to ``WINDOW_MAX_C``
    without int8 products, as the fast block picks it; 'tokens' (the
    token-parallel forward of ``csrc/token_fwd.cuh``) above, and for any
    of the int8 groups 'qkv', 'mlp', 'proj' (``int8``), which the window
    body has no product for."""
    return "window" if c <= WINDOW_MAX_C and not int8 else "tokens"


# The token-parallel forward's GEMMs (csrc/token_wgmma.cuh, ``tokwg``):
# persistent thread blocks of one or two consumer warpgroups (64 token
# rows each) and a producer warpgroup; 128-byte K slices of A (two
# buffers) and of the weights (a ring of up to six slots), 64-column wgmma
# pieces (a 64-row slice is 8 KB), staging rows of 128 bytes a tile row,
# the epilogue's per-column f32 constants, a 1024-byte alignment pad, 16
# bytes of barriers a slot and 32 for the A buffers.
_WG_SLICE, _WG_PIECE, _WG_MAX_SLOTS, _WG_ALIGN = 128, 64, 6, 1024
_WG_PIECE_BYTES = _WG_PIECE * _WG_SLICE
_WG_QKV_PIECES = 3  # the qkv product's output columns a pass: 192
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TokenGemmSched(NamedTuple):
    """One launch's schedule (``tokwg::Sched``): tiles of ``bm`` rows, A
    in ``nks`` 128-byte slices, ``ksteps`` 32-byte K-steps of products,
    the weight ring, ``na`` A buffers of ``a_bytes``, the bytes of the
    staging rows (the MLP's hidden rows, the other kernels' output rows)
    and of the epilogue's constants."""
    tiles: int
    bm: int
    nks: int
    ksteps: int
    nslots: int
    slot_bytes: int
    na: int
    a_bytes: int
    h_bytes: int
    c_bytes: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory of the launch (``tokwg::smem_bytes``)."""
        return (_WG_ALIGN + self.na * self.a_bytes
                + self.nslots * self.slot_bytes + self.h_bytes + self.c_bytes
                + 32 + 16 * self.nslots)


def token_tile_rows(tokens: int, sms: int = H100_SMS) -> int:
    """Rows a tile of the token-parallel GEMMs (``tokwg::tile_rows``): 128,
    two consumer warpgroups, once the call has at least as many 128-row
    tiles as the card has SMs; else 64, one, so that a small call (bucket
    1: 1,280 tokens) spreads over twice the SMs."""
    return 128 if _cdiv(tokens, 128) >= sms else 64


def token_gemm_sched(tokens: int, bm: int, kbytes: int, slot_bytes: int,
                     consts: int, h_slices: int = 1,
                     na: int = 2) -> TokenGemmSched:
    """``tokwg::sched``: a GEMM over ``tokens`` rows in tiles of ``bm``,
    K of ``kbytes`` bytes, weight stages of ``slot_bytes``, ``consts``
    per-column f32 constants of its epilogue, ``h_slices`` 128-byte
    columns of staging rows, ``na`` A buffers; as many ring slots (up to
    six) as an H100 block's shared memory leaves."""
    nks = _cdiv(kbytes, _WG_SLICE)
    a_bytes = bm * nks * _WG_SLICE
    h_bytes = h_slices * bm * _WG_SLICE
    c_bytes = _cdiv(4 * consts, 16) * 16
    n = ((H100_SMEM_OPTIN - _WG_ALIGN - na * a_bytes - h_bytes - c_bytes
          - 32) // (slot_bytes + 16))
    return TokenGemmSched(_cdiv(tokens, bm), bm, nks, _cdiv(kbytes, 32),
                          min(n, _WG_MAX_SLOTS), slot_bytes, na, a_bytes,
                          h_bytes, c_bytes)


def token_gemm_scheds(tokens: int, c: int, nh: int, hidden: int,
                      growth: int = 0, int8: bool = False,
                      sms: int = H100_SMS, int8_mm: bool = False) -> dict:
    """The schedules of one forward's GEMMs at this geometry (and of the
    adapter with ``growth``), as ``tokwg::qkv``, ``proj_ln``, ``mlp`` and
    ``adapter`` make them: K = C (int8 or bf16 rows) for qkv, proj, fc1
    and the adapter, 192 qkv columns a pass, one pass of ceil(N / 64)
    pieces for the row-spanning epilogues (N = C, growth), fc1 + fc2
    stages of max(K slices, fc2 pieces) 8 KB slices, the MLP's hidden rows
    in shared memory with one A buffer (64-row tiles where 128 rows of
    them leave fewer than two ring slots); constants bqkv (and the int8
    steps), bproj, bf1 and bf2, and the adapter's three. ``int8_mm``: also
    the int8 'proj' and 'mlp' products (``tokwg::proj_ln_q``, ``fc1_s8``,
    ``fc2_s8``): int8 rows of K = C (fc2: hidden) bytes, each with its
    bias and steps as constants."""
    bm = token_tile_rows(tokens, sms)
    nt = _cdiv(c, _WG_PIECE)
    nks = _cdiv(2 * c, _WG_SLICE)
    n3 = token_dims(c, nh, hidden)[3]
    out = {
        "qkv": token_gemm_sched(tokens, bm, c * (1 if int8 else 2),
                                _WG_QKV_PIECES * _WG_PIECE_BYTES,
                                (2 if int8 else 1) * n3),
        "proj": token_gemm_sched(tokens, bm, 2 * c, nt * _WG_PIECE_BYTES,
                                 c),
    }
    chunks = _cdiv(hidden, _WG_PIECE)
    mlp = token_gemm_sched(tokens, bm, 2 * c, max(nks, nt) * _WG_PIECE_BYTES,
                           hidden + c, chunks, 1)
    if mlp.nslots < 2:
        mlp = token_gemm_sched(tokens, 64, 2 * c,
                               max(nks, nt) * _WG_PIECE_BYTES, hidden + c,
                               chunks, 1)
    out["mlp"] = mlp
    if growth:
        out["adapter"] = token_gemm_sched(
            tokens, bm, 2 * c, _cdiv(growth, _WG_PIECE) * _WG_PIECE_BYTES,
            3 * growth)
    if int8_mm:
        out["proj_s8"] = token_gemm_sched(tokens, bm, c,
                                          nt * _WG_PIECE_BYTES, 2 * c)
        out["fc1_s8"] = token_gemm_sched(
            tokens, bm, c, _WG_QKV_PIECES * _WG_PIECE_BYTES, 2 * hidden)
        out["fc2_s8"] = token_gemm_sched(tokens, bm, hidden,
                                         nt * _WG_PIECE_BYTES, 2 * c)
    return out


def token_schedule(tokens: int, bm: int, sms: int = H100_SMS):
    """Which token rows each persistent block of a launch takes: block b
    of min(tiles, sms) walks tiles b, b + blocks, ...; returns a list of
    (first row, end row) ranges per block, the last tile cut at
    ``tokens``."""
    tiles = _cdiv(tokens, bm)
    blocks = min(tiles, sms)
    return [[(t * bm, min((t + 1) * bm, tokens))
             for t in range(b, tiles, blocks)] for b in range(blocks)]


def token_smem_bytes(n: int, c: int, nh: int, hidden: int,
                     growth: int = 0) -> int:
    """The most shared memory a kernel of the token-parallel forward takes
    at this geometry: its GEMMs' (``token_gemm_scheds`` at 128-row tiles,
    int8 and bf16 qkv, with ``growth`` the adapter's) and the attention
    of one (window, head)."""
    hds = _round_up(c // nh, 16)
    sizes = [2 * 3 * n * (hds + 8)]
    for int8 in (False, True):
        for s in token_gemm_scheds(H100_SMS * 128, c, nh, hidden, growth,
                                   int8, int8_mm=int8).values():
            sizes.append(s.smem)
    return max(sizes)


def token_kernel_supports(n: int, c: int, nh: int, hidden: int,
                          growth: int = 0) -> bool:
    """Whether the token-parallel forward takes this block geometry (the
    fast block above ``WINDOW_MAX_C``; the pair and RDSTB stages that
    :func:`stage_route` sends there): N a multiple of 16 up to 64, C <=
    ``FAST_MAX_C`` (its row kernels keep six values a lane, its
    row-spanning GEMM epilogues three 64-column pieces), head dim <= 32,
    hidden <= 512, growth (the adapter) <= 256, every GEMM with at least
    two ring slots at both tile heights, and its kernels in an H100
    block's shared memory."""
    if growth > 256:
        return False
    for bm_tokens in (1, H100_SMS * 128):
        for int8 in (False, True):
            if any(s.nslots < 2 for s in token_gemm_scheds(
                    bm_tokens, c, nh, hidden, growth, int8,
                    int8_mm=int8).values()):
                return False
    return fast_kernel_supports(
        n, c, nh, hidden, token_smem_bytes(n, c, nh, hidden, growth),
        max_c=FAST_MAX_C)


def token_dims(c: int, nh: int, hidden: int):
    """(kp, hp, hdg, n3, kq) of the token-parallel forward
    (``tokpar::make_dims``): C rows round_up(C + 1, 16) wide, hidden rows
    round_up(hidden + 1, 16), each head's q/k/v in round_up(hd, 8)
    channels, int8 LN1 rows round_up(C, 32)."""
    hdg = _round_up(c // nh, 8)
    return (_round_up(c + 1, 16), _round_up(hidden + 1, 16), hdg,
            3 * nh * hdg, _round_up(c, 32))


def token_layout(p: FastParams, nh: int):
    """The token-parallel forward's weights: wqkv (kp, n3) [k][n] with each
    head's q, k, v in hdg columns, bqkv (n3) float32 in the same order;
    wproj (kp, kp), w1 (kp, hp), w2 (hp, kp) [k][n]; bproj, bf1, bf2 as
    they are. Pads are zero."""
    c, hidden = p.wproj.shape[0], p.w1.shape[1]
    hd = c // nh
    kp, hp, hdg, n3, _ = token_dims(c, nh, hidden)
    dev = p.wqkv.device

    def z(*shape, dtype=BF16):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    wqkv = z(kp, 3, nh, hdg)
    wqkv[:c, :, :, :hd] = p.wqkv.reshape(c, 3, nh, hd)
    bqkv = z(3, nh, hdg, dtype=torch.float32)
    bqkv[:, :, :hd] = p.bqkv.reshape(3, nh, hd)
    wproj = z(kp, kp)
    wproj[:c, :c] = p.wproj
    w1 = z(kp, hp)
    w1[:c, :hidden] = p.w1
    w2 = z(hp, kp)
    w2[:hidden, :c] = p.w2
    return (wqkv.reshape(kp, n3), bqkv.reshape(-1), wproj, p.bproj, w1,
            p.bf1, w2, p.bf2)


def token_wgmma_layout(layout):
    """The weights as the token-parallel forward's GEMMs read them
    (``csrc/token_wgmma.cuh``): :func:`token_layout`'s, every weight
    matrix K-major -- wqkv (n3, kp), wproj (kp, kp), w1 (hp, kp), w2 (kp,
    hp), each [n][k] -- and the biases as they are. The transposes give
    :func:`token_layout`'s matrices back."""
    wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2 = layout
    return (wqkv.t().contiguous(), bqkv, wproj.t().contiguous(), bproj,
            w1.t().contiguous(), bf1, w2.t().contiguous(), bf2)


def qkv_token_layout(q: Optional[QkvQuant], c: int, nh: int):
    """The token-parallel forward's int8 qkv operands: wq (n3, kq) int8
    [n][k] by head, ws (n3) float32 in the same order; empty for bf16
    qkv."""
    if q is None:
        return ()
    hd = c // nh
    _, _, hdg, n3, kq = token_dims(c, nh, 2 * c)
    dev = q.wq.device
    wq = torch.zeros(3, nh, hdg, kq, dtype=torch.int8, device=dev)
    wq[:, :, :hd, :c] = q.wq.reshape(c, 3, nh, hd).permute(1, 2, 3, 0)
    ws = torch.zeros(3, nh, hdg, dtype=torch.float32, device=dev)
    ws[:, :, :hd] = q.ws.reshape(3, nh, hd)
    return wq.reshape(n3, kq), ws.reshape(-1)


def int8_token_layout(mlp: Optional[MlpQuant], proj: Optional[ProjQuant],
                      c: int, hidden: int):
    """The token-parallel forward's int8 fc1, fc2 and projection operands,
    every weight K-major [n][k] with rows of K rounded up to 32: w1q
    (hidden, kq), w1s (hidden), w2q (c, kh), w2s (c), wpq (c, kq), wps (c),
    kq = round_up(c, 32), kh = round_up(hidden, 32); 0 in place of a
    group's two operands where it is off."""
    kq, kh = _round_up(c, 32), _round_up(hidden, 32)

    def kmajor(wq, rows, k):  # (in, out) int8 -> (out, k) [n][k]
        out = torch.zeros(rows, k, dtype=torch.int8, device=wq.device)
        out[:, :wq.shape[0]] = wq.t()
        return out

    out = []
    if mlp is None:
        out += [0, 0, 0, 0]
    else:
        out += [kmajor(mlp.w1q, hidden, kq), mlp.w1s.contiguous(),
                kmajor(mlp.w2q, c, kh), mlp.w2s.contiguous()]
    if proj is None:
        out += [0, 0]
    else:
        out += [kmajor(proj.wq, c, kq), proj.ws.contiguous()]
    return tuple(out)


def int8_mask(mlp, proj) -> int:
    """The token-parallel forward's int8 flags: 1 the projection, 2 the
    MLP (``tokfwd::kInt8Proj``, ``kInt8Mlp``)."""
    return (1 if proj is not None else 0) | (2 if mlp is not None else 0)


class FastBlockPlan(NamedTuple):
    """One block's fast-branch operands, prepared once (:func:`plan_fast_block`)."""
    params: FastParams
    bias: torch.Tensor  # packed (bw, N, nH*N) bf16
    layout: tuple       # the route's weight layout on a CUDA device, else ()
    qkv: Optional[QkvQuant] = None  # int8 qkv operands, or None
    qkv_layout: tuple = ()  # their layout for the route on a CUDA device
    # 'window' (the persistent window kernel) or 'stage' (the pair's stage
    # kernels), both window_body.stage_layout and stage_bias; 'tokens'
    # (token_wgmma_layout)
    route: str = "window"
    mlp: Optional[MlpQuant] = None    # int8 fc1 / fc2 operands, or None
    proj: Optional[ProjQuant] = None  # int8 projection operands, or None
    int8_layout: tuple = ()  # int8_token_layout on a CUDA device

    @property
    def int8_mask(self) -> int:
        return int8_mask(self.mlp, self.proj)

    @property
    def quant(self) -> BlockQuant:
        """The plan's int8 operands by group."""
        return BlockQuant(self.qkv, self.mlp, self.proj)

    def token_ptrs(self) -> list:
        """The block's operands as ``tokfwd::BlockW`` reads them (its
        ``kBlockPtrs`` pointers, 0 for an int8 group that is off)."""
        return [*self.layout, self.bias, *(self.qkv_layout or (0, 0)),
                *(self.int8_layout or (0,) * 6)]


def plan_fast_block(params, bias, *, num_heads: int, quant=frozenset(),
                    route: Optional[str] = None) -> FastBlockPlan:
    """Fold a block's 12-param bundle (JAX layout) and pack its
    head-major bias; for the int8 groups of ``quant`` ('qkv', 'mlp',
    'proj'; 'conv' is the RDSTB's and ignored) also quantize the folded
    weights to int8 (``quant.block_quant``); on a CUDA device lay the
    weights out for the kernel. ``route``: the design the plan is for, by
    default the fast block's own (:func:`fast_route`, and 'tokens' where
    the window kernel does not take the geometry); the pair's stage
    kernels ask for 'stage'. 'window' and 'stage' take
    ``csrc/window_body.cuh``'s weight panels and no int8 group: asked for
    where the card's kernel would refuse them, they raise on either
    device and name route 'tokens'. Depends on the weights only, so a
    caller may keep it."""
    from rdst_tpu_torch.kernels.quant import check_ported

    c, nh = params[0].shape[0], num_heads
    if bias.dim() != 3 or bias.shape[0] % nh or bias.shape[1] != bias.shape[2]:
        raise ValueError(f"bias must be head-major (nH*bw, N, N), got "
                         f"{tuple(bias.shape)}")
    if route not in (None, "window", "tokens", "stage"):
        raise ValueError(f"route {route!r}: expected 'window', 'tokens' or "
                         "'stage'")
    n, hidden = bias.shape[1], params[8].shape[1]
    groups = check_ported(quant)
    int8 = bool(groups)
    if route is None:
        route = fast_route(c, int8)
        if route == "window" and not window_kernel_supports(n, c, nh,
                                                            hidden):
            route = "tokens"
    if route != "tokens" and int8:
        raise ValueError(f"the {route} kernels take bf16 qkv only and no "
                         f"int8 product (pallas_quant {sorted(groups)}): "
                         "route 'tokens', the token-parallel forward, takes "
                         "them")
    if route == "window" and not window_kernel_supports(n, c, nh, hidden):
        raise ValueError(f"the window kernel does not take N={n}, C={c}, "
                         f"heads={nh}, hidden={hidden} (route 'tokens', the "
                         "token-parallel forward, takes C up to 192)")
    p = fast_params(params, c, nh)
    packed = pack_bias_fast(bias, nh, n)
    q = block_quant(p, groups)
    if packed.device.type != "cuda":
        return FastBlockPlan(p, packed, (), q.qkv, (), route, q.mlp, q.proj)
    if route == "tokens":
        return FastBlockPlan(p, packed, token_wgmma_layout(token_layout(
            p, nh)), q.qkv, qkv_token_layout(q.qkv, c, nh), route, q.mlp,
            q.proj, int8_token_layout(q.mlp, q.proj, c, hidden))
    from rdst_tpu_torch.kernels.window_body import stage_bias, stage_layout

    return FastBlockPlan(p, packed, stage_layout(kernel_layout(p), c, nh)
                         + (stage_bias(packed, nh),), None, (), route)


def run_fast_block(x_windows, plan: FastBlockPlan, *, num_heads: int,
                   windows_per_image: int, softmax: str = "", pack: int = 1):
    """The fast block on bf16 window-layout tokens (B*nW, N, C) with a
    prepared plan. A CPU tensor takes :func:`swin_block_fast_reference`;
    a CUDA tensor launches ``csrc/swin_block_fast.cu`` in the plan's
    design (the token-parallel forward's kernels, or the persistent
    window kernel; one count either way) or raises; geometry the kernel
    does not take raises on either device. The plan's int8 operands,
    when it has them, go with it (the token-parallel forward's); the
    dynamic scales of int8 'mlp' and 'proj' are taken over the windows
    one program of the JAX kernel holds (``quant.block_group_windows``,
    ``pack`` 2 for the 'pack' mode)."""
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    nh, nw = num_heads, windows_per_image
    p = plan.params
    hidden = p.w1.shape[-1]
    code = softmax_code(softmax)
    if plan.route == "stage":
        raise ValueError("a 'stage' plan is the pair's: plan the fast block "
                         "with route 'window' or 'tokens'")
    if not fast_kernel_supports(n, c, nh, hidden, max_c=FAST_MAX_C):
        raise ValueError(
            f"fused_swin_block (bf16): the CUDA kernel does not take N={n}, "
            f"C={c}, heads={nh}, hidden={hidden} (needs N a multiple of 16 "
            f"up to 64, C <= {FAST_MAX_C}, head dim <= 32 and "
            f"{fast_smem_bytes(n, c, nh, hidden)} <= {H100_SMEM_OPTIN} bytes"
            " of shared memory); build with pallas_kernels='off'")
    bw = plan.bias.shape[0]
    if (p.wqkv.shape[0] != c or tuple(plan.bias.shape[1:]) != (n, nh * n)
            or bw not in (1, nw)):
        raise ValueError(f"plan for C={p.wqkv.shape[0]}, bias "
                         f"{tuple(plan.bias.shape)} does not fit N={n}, C={c},"
                         f" {nh} heads, {nw} windows per image")
    if t % bw:
        raise ValueError(f"{t} windows are not whole images of {nw}")
    check_fast_tokens("x_windows", x_windows, (t, n, c))
    dev = x_windows.device
    if plan.bias.device != dev:
        raise ValueError(f"plan is on {plan.bias.device}, x_windows on {dev}")
    gw = t
    if plan.int8_mask and t:
        from rdst_tpu_torch.kernels.quant import block_group_windows

        gw = block_group_windows(t, nw, n, c, nh, hidden, bw,
                                 softmax=softmax, pack=pack)
    if dev.type == "cpu":
        return swin_block_fast_reference(x_windows, p, plan.bias,
                                         num_heads=nh, softmax=softmax,
                                         qkv=plan.qkv, mlp=plan.mlp,
                                         proj=plan.proj, group_windows=gw)
    out = torch.empty_like(x_windows)
    if t == 0:
        return out
    lib = _build.load(_FAST_SOURCE)
    dims = [t, n, c, nh, hidden, bw, code]
    if plan.route == "tokens":
        dims += [gw, plan.int8_mask]
        work = torch.empty(work_bytes(lib, "swin_block_fast_work_bytes", dims),
                           dtype=torch.uint8, device=dev)
        launch(lib, "swin_block_fast_tokens",
               [x_windows, out, *plan.token_ptrs(), work], dims, dev)
        run_fast_block.kernels += token_fwd_kernels(plan.int8_mask)
    else:
        _launch_window(lib, x_windows, out, plan, dims, True)
        run_fast_block.kernels += 1
    run_fast_block.launches += 1
    return out


run_fast_block.launches = 0  # kernel launches since the last reset
run_fast_block.kernels = 0   # kernels those launches ran


def token_fwd_kernels(mask: int = 0) -> int:
    """Kernels of one token-parallel forward (``tokfwd::fwd_kernels``): LN1,
    qkv, attention, the projection and the fused MLP; int8 'proj' adds the
    attention output's quantize pass, int8 'mlp' runs fc1, the hidden
    rows' quantize pass and fc2 in the fused MLP's place."""
    return 5 + (mask & 1) + 2 * ((mask >> 1) & 1)


def _launch_window(lib, x, out, plan, dims, turns: bool) -> None:
    if x.data_ptr() % 16:  # its tiles come in by bulk copies
        x = x.clone()
    launch(lib, "swin_block_fast_window", [x, out, *plan.layout],
           dims + [int(turns)], x.device)


def window_kernel_without_turns(x_windows, plan: FastBlockPlan, *,
                                num_heads: int, softmax: str = ""):
    """A measurement, not a path of the model: the persistent window
    kernel with its two warpgroups running free of the tensor-core turns
    (``chip_smoke.py`` phase 7 times it beside the kernel to see what the
    turns overlap). Only where every weight is resident (the streamed
    panels' ring needs the turns' order): C = 60. Bias shared or per
    window of one image, as ``run_fast_block``; CUDA only, not
    counted."""
    from rdst_tpu_torch.kernels import window_body as wb

    t, n, c = x_windows.shape
    hidden = plan.params.w1.shape[-1]
    g = wb.make_geom(n, c, num_heads, hidden)
    if (plan.route != "window" or x_windows.device.type != "cuda"
            or wb.persist_fit(g).nslots):
        raise ValueError("the window kernel runs without turns only on the "
                         "card, where every weight is resident")
    out = torch.empty_like(x_windows)
    _launch_window(_build.load(_FAST_SOURCE), x_windows, out, plan,
                   [t, n, c, num_heads, hidden, plan.bias.shape[0],
                    softmax_code(softmax)], False)
    return out
