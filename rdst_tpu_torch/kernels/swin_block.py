"""Fused Swin transformer block: the CUDA kernel and its plain PyTorch version.

Counterpart of ``rdst_tpu/kernels/swin_block.py::fused_swin_block`` in its
float32 precise branch (``_body`` with ``fast=False``): one whole Swin
block on window-layout tokens,

    LN1 -> qkv -> W-MSA (rel-pos bias + shift mask) -> proj -> +residual
        -> LN2 -> MLP (erf GELU) -> +residual,

with the same argument layout as the JAX function: weights (in, out),
LayerNorm affines (C,), and a head-major bias (nH*nW, N, N) per window
(shifted block) or (nH, N, N) shared by every window.

:func:`fused_swin_block` launches ``csrc/swin_block.cu`` for a CUDA
tensor and counts the launch in ``fused_swin_block.launches``; for a CPU
tensor it computes :func:`swin_block_reference`. What the kernel does
not take raises on either device, so the CPU path refuses what the card
would; on the card it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from rdst_tpu_torch.kernels import _build

_EPS = 1e-5  # torch-default LayerNorm epsilon
_SOURCE = "swin_block.cu"
_THREADS = 256  # smaller block size of csrc/swin_block.cu: N must divide it
_MAX_HEAD_DIM = 32
H100_SMEM_OPTIN = 232448  # bytes of shared memory one block may opt into

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
                     num_heads: int, windows_per_image: int):
    """Whole Swin block on window-layout tokens (B*nW, N, C).

    Arguments the CUDA kernel does not take raise on every device. Then
    a CPU tensor takes :func:`swin_block_reference`, and a CUDA tensor
    launches the CUDA kernel (one thread block per window) or raises."""
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
