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
  ``csrc/swin_block.cu``, plain version :func:`swin_block_reference`;
* bfloat16 -> the fast branch (``fast=True``): LN affines and the q
  scale folded into the weights (:func:`prep_block_params`),
  normalize-only one-pass LayerNorm, a softmax stabilizer chosen by
  variant, approximate reciprocal, tanh GELU, bf16 roundings where the
  TPU kernel rounds, optionally int8 qkv operands (``pallas_quant=
  'qkv'``, ``kernels.quant``): ``csrc/swin_block_fast.cu`` (its window
  body is ``csrc/fast_block.cuh``, shared with the pair, RDSTB and train
  kernels), plain version :func:`swin_block_fast_reference`. It takes C
  up to ``FAST_MAX_C`` (SwinIR-std's 180); the pair, RDSTB and train-pair
  kernels stay at the ``SHARED_MAX_C`` they were verified at.

Both count their launches (``fused_swin_block.launches`` and
``run_fast_block.launches``). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. What a kernel does
not take raises on either device, so the CPU path refuses what the card
would; on the card nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.quant import (QX, QkvQuant, int8_matmul,
                                          qkv_kernel_layout, qkv_quant,
                                          quant_rows)

_EPS = 1e-5  # torch-default LayerNorm epsilon
_SOURCE = "swin_block.cu"
_THREADS = 256  # smaller block size of csrc/swin_block.cu: N must divide it
_MAX_HEAD_DIM = 32
H100_SMEM_OPTIN = 232448  # bytes of shared memory one block may opt into
# widest C of the fast block and the single-block train kernels
# (``fastblk::kMaxC``), and of the pair, RDSTB and train-pair kernels
# (``fastblk::kMaxCShared``)
FAST_MAX_C = 192
SHARED_MAX_C = 128

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


def smem_bytes(n: int, c: int, hidden: int) -> int:
    """Dynamic shared memory of one launch (``swin_block_smem_bytes`` in
    the CUDA source): x rows; LN/attention rows at a stride rounded up to
    4; q/k/v at row stride C+1, reused by the MLP hidden state (stride
    rounded up to 4); one head's scores."""
    cs, hs = -(-c // 4) * 4, -(-hidden // 4) * 4
    return 4 * (n * c + n * cs + max(3 * n * (c + 1), n * hs) + n * n)


def block_kernel_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the CUDA kernel takes this block geometry on an H100."""
    return (0 < n <= 64 and _THREADS % n == 0 and n % 8 == 0
            and c % 2 == 0 and c % nh == 0 and c // nh <= _MAX_HEAD_DIM
            and hidden % 2 == 0
            and smem_bytes(n, c, hidden) <= H100_SMEM_OPTIN)


def _layernorm(x, gamma, beta):
    """Two-pass LayerNorm (mean subtracted before the variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + _EPS) * gamma + beta


def swin_block_reference(x_windows, wqkv, bqkv, wproj, bproj,
                         g1, b1, g2, b2, w1, bf1, w2, bf2, bias, *,
                         num_heads: int, windows_per_image: int):
    """Plain PyTorch version of the kernel (same arguments). x_windows:
    (B*nW, N, C); returns (B*nW, N, C)."""
    t, n, c = x_windows.shape
    nh = num_heads
    hd = c // nh
    x = x_windows
    if bqkv is None:
        bqkv = x.new_zeros(3 * c)
    xn = _layernorm(x, g1, b1)
    qkv = xn @ wqkv + bqkv
    q = (qkv[..., :c] * hd**-0.5).reshape(t, n, nh, hd).transpose(1, 2)
    k = qkv[..., c:2 * c].reshape(t, n, nh, hd).transpose(1, 2)
    v = qkv[..., 2 * c:].reshape(t, n, nh, hd).transpose(1, 2)
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
    p = torch.softmax(s, dim=-1)
    o = (p @ v).transpose(1, 2).reshape(t, n, c)
    x1 = x + (o @ wproj + bproj)
    h1 = _layernorm(x1, g2, b2) @ w1 + bf1
    h1 = 0.5 * h1 * (1.0 + torch.erf(h1 * 2.0**-0.5))
    return x1 + (h1 @ w2 + bf2)


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_rdst_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.swin_block_f32.argtypes = [vp] * 15 + [ci] * 7 + [vp]
        lib.swin_block_f32.restype = ci
        lib.swin_block_error_string.argtypes = [ci]
        lib.swin_block_error_string.restype = ctypes.c_char_p
        lib._rdst_typed = True
    return lib


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


def fused_swin_block(x_windows, wqkv, bqkv, wproj, bproj,
                     g1, b1, g2, b2, w1, bf1, w2, bf2, bias, *,
                     num_heads: int, windows_per_image: int,
                     softmax: str = ""):
    """Whole Swin block on window-layout tokens (B*nW, N, C).

    bfloat16 tokens take the fast branch (:func:`plan_fast_block`, then
    :func:`run_fast_block`, with the softmax variant ``softmax``);
    float32 tokens the precise branch below. Arguments the CUDA kernel does not take raise on every
    device. Then a CPU tensor takes :func:`swin_block_reference`, and a
    CUDA tensor launches the CUDA kernel (one thread block per window)
    or raises."""
    if x_windows.dtype == torch.bfloat16:
        plan = plan_fast_block(
            (wqkv, bqkv, wproj, bproj, g1, b1, g2, b2, w1, bf1, w2, bf2),
            bias, num_heads=num_heads)
        return run_fast_block(x_windows, plan, num_heads=num_heads,
                              windows_per_image=windows_per_image,
                              softmax=softmax)
    dev = x_windows.device
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    nh, nw = num_heads, windows_per_image
    hidden = w1.shape[-1]
    if not block_kernel_supports(n, c, nh, hidden):
        raise ValueError(
            f"fused_swin_block: the CUDA kernel does not take N={n}, C={c}, "
            f"heads={nh}, hidden={hidden} (needs N | {_THREADS}, N % 8 == 0,"
            f" N <= 64, even C and hidden, head dim <= {_MAX_HEAD_DIM} and "
            f"{smem_bytes(n, c, hidden)} <= {H100_SMEM_OPTIN} bytes of "
            "shared memory)")
    if bias.dim() != 3 or bias.shape[0] not in (nh, nh * nw):
        raise ValueError(f"bias must be ({nh}*{nw} or {nh}, {n}, {n}), got "
                         f"{tuple(bias.shape)}")
    bias_windows = bias.shape[0] // nh
    if t % bias_windows:
        raise ValueError(f"{t} windows are not whole images of {nw}")
    if bqkv is None:
        bqkv = torch.zeros(3 * c, device=dev, dtype=torch.float32)
    args = (("x_windows", x_windows, (t, n, c)), ("wqkv", wqkv, (c, 3 * c)),
            ("bqkv", bqkv, (3 * c,)), ("wproj", wproj, (c, c)),
            ("bproj", bproj, (c,)), ("g1", g1, (c,)), ("b1", b1, (c,)),
            ("g2", g2, (c,)), ("b2", b2, (c,)), ("w1", w1, (c, hidden)),
            ("bf1", bf1, (hidden,)), ("w2", w2, (hidden, c)),
            ("bf2", bf2, (c,)), ("bias", bias, (nh * bias_windows, n, n)))
    for name, tensor, shape in args:
        _check(name, tensor, shape, dev)
    if dev.type == "cpu":
        return swin_block_reference(
            x_windows, wqkv, bqkv, wproj, bproj, g1, b1, g2, b2,
            w1, bf1, w2, bf2, bias, num_heads=num_heads,
            windows_per_image=windows_per_image)
    if dev.type != "cuda":
        raise ValueError(f"fused_swin_block: unsupported device {dev}")
    out = torch.empty_like(x_windows)
    if t == 0:
        return out
    lib = _lib()
    ptrs = [a[1].data_ptr() for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.swin_block_f32(
        ptrs[0], out.data_ptr(), *ptrs[1:], t, n, c, nh, hidden,
        bias_windows, dev.index if dev.index is not None
        else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(
            "swin_block_f32 launch failed: "
            f"{lib.swin_block_error_string(err).decode()} (error {err})")
    fused_swin_block.launches += 1
    return out


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


def fast_body(xf, p: FastParams, bias, *, num_heads: int, softmax: str,
              dpf=None, qkv: Optional[QkvQuant] = None):
    """The fast block body on float32 tokens (T, N, C) with its bf16
    roundings, as ``_body(fast=True)`` computes it; returns float32.

    ``bias`` is the packed (bw, N, nH*N) bf16 bias, bw = 1 (shared) or
    the bias period in windows. The softmax normalizer is an exact
    division here (the inference kernels use an approximate reciprocal;
    the training kernel divides exactly, as ``exact_recip=True``).
    ``dpf``: optional (attn, mlp) stochastic-depth factor columns, each
    (T*N,) float32, that scale the two residual branches (``_body``'s
    ``dpf``). ``qkv``: int8 qkv operands (``kernels.quant``); then the
    float32 normalized rows are quantized, not their bf16 rounding, and
    q, k, v = bf16(int32(xq @ wq) * ws + bqkv). Differentiable with
    ``torch.autograd`` (without ``qkv``)."""
    code = softmax_code(softmax)
    t, n, c = xf.shape
    nh = num_heads
    hd = c // nh
    if qkv is None:
        xn = _bf(normalize(xf))

        def proj(i):
            return _bf(_mm(xn, p.wqkv[:, i * c:(i + 1) * c])
                       + p.bqkv[i * c:(i + 1) * c])
    else:
        xq = quant_rows(normalize(xf), QX)

        def proj(i):
            cols = slice(i * c, (i + 1) * c)
            return _bf(int8_matmul(xq, qkv.wq[:, cols]) * qkv.ws[cols]
                       + p.bqkv[cols])

    def heads(u):  # (T, N, C) -> (T, nH, N, hd)
        return u.reshape(t, n, nh, hd).transpose(1, 2)

    q, k, v = heads(proj(0)), heads(proj(1)), heads(proj(2))
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
    o = _mm(e, v) / den  # (T, nH, N, hd)
    o = _bf(o.transpose(1, 2).reshape(t, n, c))
    y = _mm(o, p.wproj) + p.bproj.float()
    if dpf is not None:
        y = y * dpf[0].reshape(t, n, 1)
    x1 = xf + y
    h1 = _bf(gelu_tanh(_mm(_bf(normalize(x1)), p.w1) + p.bf1))
    h2 = _mm(h1, p.w2) + p.bf2.float()
    if dpf is not None:
        h2 = h2 * dpf[1].reshape(t, n, 1)
    return x1 + h2


def swin_block_fast_reference(x_windows, p: FastParams, bias, *,
                              num_heads: int, softmax: str,
                              qkv: Optional[QkvQuant] = None):
    """Plain PyTorch version of the fast block kernel: bf16 tokens
    (B*nW, N, C), folded params, packed bias, optional int8 qkv
    operands; returns bf16."""
    return _bf(fast_body(x_windows.float(), p, bias, num_heads=num_heads,
                         softmax=softmax, qkv=qkv))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def fast_smem_bytes(n: int, c: int, nh: int, hidden: int) -> int:
    """Dynamic shared memory of one window's fast block (``smem_layout``
    in ``csrc/fast_block.cuh``): x rows f32; the LN / attention-output
    rows (bf16, stride cp + 8); q and k with each head padded to 8
    channels, v transposed and padded to 8, all bf16, sharing their
    region with the MLP hidden rows."""
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
    C <= ``max_c`` (``FAST_MAX_C`` for the fast block and the
    single-block train kernels, ``SHARED_MAX_C`` for the pair, RDSTB and
    train-pair kernels), and one window's working set in an H100 block's
    shared memory."""
    smem = fast_smem_bytes(n, c, nh, hidden) if smem is None else smem
    return (0 < n <= 64 and n % 16 == 0 and 0 < c <= max_c and nh > 0
            and c % nh == 0 and c // nh <= 32 and 0 < hidden <= 512
            and smem <= H100_SMEM_OPTIN)


def kernel_layout(p: FastParams):
    """The CUDA kernels' weight layout: each weight transposed to
    (out, in) and zero-padded to multiples of 16 (qkv as three (cp, cp)
    parts), biases zero-padded. Pads are zero, so padded channels come
    out zero."""
    c, hidden = p.wproj.shape[0], p.w1.shape[1]
    cp, hp = _round_up(c, 16), _round_up(hidden, 16)
    dev = p.wqkv.device

    def z(*shape, dtype=BF16):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    wqkv = z(3, cp, cp)
    wqkv[:, :c, :c] = p.wqkv.reshape(c, 3, c).permute(1, 2, 0)
    bqkv = z(3, cp, dtype=torch.float32)
    bqkv[:, :c] = p.bqkv.reshape(3, c)
    wproj = z(cp, cp)
    wproj[:c, :c] = p.wproj.t()
    bproj = z(cp)
    bproj[:c] = p.bproj
    w1 = z(hp, cp)
    w1[:hidden, :c] = p.w1.t()
    bf1 = z(hp, dtype=torch.float32)
    bf1[:hidden] = p.bf1
    w2 = z(cp, hp)
    w2[:c, :hidden] = p.w2.t()
    bf2 = z(cp)
    bf2[:c] = p.bf2
    return (wqkv.reshape(3 * cp, cp), bqkv.reshape(-1), wproj, bproj, w1,
            bf1, w2, bf2)


def launch(lib, entry: str, ptrs, dims, device) -> None:
    """Call a fast-branch entry ``int entry(const void* const* ptrs,
    const int* dims, int device, void* stream)`` on the current stream
    and raise on a non-zero cudaError_t."""
    fn = getattr(lib, entry)
    if not getattr(fn, "_rdst_typed", False):
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fast_error_string.argtypes = [ctypes.c_int]
        lib.fast_error_string.restype = ctypes.c_char_p
        fn._rdst_typed = True
    vals = [t if isinstance(t, int) else t.data_ptr() for t in ptrs]
    arr = (ctypes.c_void_p * len(vals))(*vals)
    dim = (ctypes.c_int * len(dims))(*[int(d) for d in dims])
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(arr, dim, index, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.fast_error_string(err).decode()} "
                           f"(error {err})")


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


class FastBlockPlan(NamedTuple):
    """One block's fast-branch operands, prepared once (:func:`plan_fast_block`)."""
    params: FastParams
    bias: torch.Tensor  # packed (bw, N, nH*N) bf16
    layout: tuple       # kernel_layout(params) on a CUDA device, else ()
    qkv: Optional[QkvQuant] = None  # int8 qkv operands, or None
    qkv_layout: tuple = ()  # their kernel layout on a CUDA device


def plan_fast_block(params, bias, *, num_heads: int,
                    quant=frozenset()) -> FastBlockPlan:
    """Fold a block's 12-param bundle (JAX layout) and pack its
    head-major bias; with ``'qkv'`` in ``quant`` also quantize the folded
    qkv weight to int8; on a CUDA device lay the weights out for the
    kernel. Depends on the weights only, so a caller may keep it."""
    from rdst_tpu_torch.kernels.quant import check_ported

    c, nh = params[0].shape[0], num_heads
    if bias.dim() != 3 or bias.shape[0] % nh or bias.shape[1] != bias.shape[2]:
        raise ValueError(f"bias must be head-major (nH*bw, N, N), got "
                         f"{tuple(bias.shape)}")
    p = fast_params(params, c, nh)
    packed = pack_bias_fast(bias, nh, bias.shape[1])
    q = qkv_quant(p.wqkv) if "qkv" in check_ported(quant) else None
    cuda = packed.device.type == "cuda"
    return FastBlockPlan(p, packed, kernel_layout(p) if cuda else (), q,
                         qkv_kernel_layout(q, c, _round_up(c, 16))
                         if cuda else ())


def run_fast_block(x_windows, plan: FastBlockPlan, *, num_heads: int,
                   windows_per_image: int, softmax: str = ""):
    """The fast block on bf16 window-layout tokens (B*nW, N, C) with a
    prepared plan. A CPU tensor takes :func:`swin_block_fast_reference`;
    a CUDA tensor launches ``csrc/swin_block_fast.cu`` (one thread block
    per window) or raises; geometry the kernel does not take raises on
    either device. The plan's int8 qkv operands, when it has them, go
    with it."""
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    nh, nw = num_heads, windows_per_image
    p = plan.params
    hidden = p.w1.shape[-1]
    code = softmax_code(softmax)
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
    if dev.type == "cpu":
        return swin_block_fast_reference(x_windows, p, plan.bias,
                                         num_heads=nh, softmax=softmax,
                                         qkv=plan.qkv)
    out = torch.empty_like(x_windows)
    if t == 0:
        return out
    launch(_build.load(_FAST_SOURCE), "swin_block_fast_bf16",
           [x_windows, out, *plan.layout, plan.bias,
            *(plan.qkv_layout or (0, 0))],
           [t, n, c, nh, hidden, bw, code], dev)
    run_fast_block.launches += 1
    return out


run_fast_block.launches = 0  # kernel launches since the last reset
