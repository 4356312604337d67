"""One differentiable Swin block of the bf16 training step: the CUDA
forward and backward kernels, their plain PyTorch version, and the JAX
package's admission rules for the training kernels.

Counterpart of ``rdst_tpu/kernels/block_train.py::fused_swin_block_train``:
the fast block body (``kernels.swin_block.fast_body``) on window-layout
tokens with the two training differences of the JAX kernel, an exact
division of the softmax normalizer and optional stochastic-depth factor
columns ``dp_cols`` (B*nW*N, 2) = [attn, mlp] on the residual branches;
the bias shared by every window (1, N, nH*N) or one per window (nW, N,
nH*N) of a shifted block. The JAX package runs it where the DSTL-pair
train kernel does not fit (SwinIR-std, C = 180) or where
``pallas_train='block'`` asks for it.

Folding (``fast_params``, ``pack_bias_fast``) stays outside the kernels in
plain torch, so autograd carries the folded gradients back to the raw
parameters. On a CPU tensor :func:`run_block_train` computes
:func:`block_train_reference` (autograd differentiates it); on a CUDA
tensor it applies :class:`BlockTrainFunction`, whose forward launches
``block_train_fwd_bf16`` (the token-parallel forward, five kernels over
all the launch's tokens, its GEMMs on ``csrc/token_wgmma.cuh``; the
weights as :func:`forward_layout` lays them out) and whose backward
``block_train_bwd_bf16`` of ``csrc/block_train.cu`` (13 kernels over all
the launch's tokens, one of them the attention VJP), each wrapper call
counted
(``launch_forward.launches``, ``launch_backward.launches``;
``launch_backward.reductions`` counts the backward's other kernels).
:func:`block_bwd_reference` computes that backward by hand in plain
PyTorch, phase by phase, at the kernel's bf16 rounding points: the CPU
oracle of the kernel's phases. What the kernels do not take raises on
either device; on the card nothing falls back to the plain version.

The admission rules (:func:`vmem_estimate` ... :func:`fused_block_train_fits`)
are own copies of the JAX package's VMEM models. They decide, as the
JAX package decides, which layers train on the pair kernel and which on
this one (``nn.swin.BasicLayer.train_route``); they say nothing of what
the CUDA kernels can take.
"""

from __future__ import annotations

import ctypes

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.swin_block import (
    BF16, FAST_MAX_C, H100_SMEM_OPTIN, SOFTMAX_CODES, FastParams,
    check_fast_tokens, fast_body, fast_params, gelu_tanh, launch, normalize,
    pack_bias_fast, softmax_code, token_kernel_supports, token_layout,
    token_smem_bytes, token_wgmma_layout, work_bytes)

_SOURCE = "block_train.cu"

# ------------------------------------------------------------------------
# The JAX package's admission rules (pure arithmetic)
# ------------------------------------------------------------------------

TRAIN_VMEM_FACTOR = 6.0          # block_train.py / pair_train.py
TRAIN_VMEM_BUDGET = 32 * 2**20


def _pad128(v: int) -> int:
    return -(-v // 128) * 128


def vmem_estimate(t, n, c, nh, hidden, nw, es, fast=False,
                  softmax: str = "") -> float:
    """``swin_block._vmem_estimate``: the JAX block kernel's peak VMEM at
    t windows per program. ``softmax`` stands for the trace-time
    ``RDST_TPU_PALLAS_SOFTMAX``: every variant but 'clamp' keeps one more
    scores-sized buffer."""
    tn = t * n
    weights = (3 * c * _pad128(c) + c * _pad128(c) + c * _pad128(hidden)
               + hidden * _pad128(c)) * es
    if fast:
        act = tn * (_pad128(c) * (22 + 3 * es)
                    + _pad128(nh * n) * (4 + es)
                    + _pad128(hidden) * (4 + es)
                    + _pad128(nh) * 4)
        if softmax != "clamp":
            act += tn * _pad128(nh * n) * es
        stacks = 2 * t * nh * n * _pad128(c) * es
        bias = nw * n * _pad128(nh * n) * es
        return 0.48 * (act + stacks + weights + bias)
    act = tn * (_pad128(c) * (16 + 5 * es) + _pad128(n) * 12
                + _pad128(hidden) * (4 + es))
    bias = nh * nw * n * _pad128(n) * es
    return 0.8 * (act + weights + bias)


def pair_vmem_estimate(t, n, c, nh, hidden, nw, es, softmax="") -> float:
    """``swin_block._pair_vmem_estimate``."""
    single = vmem_estimate(t, n, c, nh, hidden, nw, es, True, softmax)
    weights = (3 * c * _pad128(c) + c * _pad128(c) + c * _pad128(hidden)
               + hidden * _pad128(c)) * es
    relayout = 3 * t * n * _pad128(c) * es
    return single + 0.48 * weights + relayout


def fused_pair_train_fits(nw, n, c, nh, hidden, es=2, softmax="") -> bool:
    """``pair_train.fused_pair_train_fits``: one image's pair backward in
    the training budget (bf16 only)."""
    return es == 2 and (TRAIN_VMEM_FACTOR * pair_vmem_estimate(
        nw, n, c, nh, hidden, nw, es, softmax) <= TRAIN_VMEM_BUDGET)


def chunk_geometry(bnw, nw, n, c, nh, hidden, es, bw_full,
                   images_per_program, softmax=""):
    """``block_train._chunk_geometry``: the JAX kernel's (t, tile, nblk)
    -- whole image(s) per program when they fit the training budget,
    else the largest window chunk t | nW that does; None when nothing
    fits."""
    db_bytes = bw_full * n * _pad128(nh * n) * 4

    def fits(t_, bw_):
        return (TRAIN_VMEM_FACTOR * vmem_estimate(t_, n, c, nh, hidden, bw_,
                                                  es, True, softmax)
                + db_bytes <= TRAIN_VMEM_BUDGET)

    if fits(nw, bw_full):
        ipp = max(1, images_per_program)
        while ipp > 1 and (bnw % (nw * ipp) != 0
                           or not fits(nw * ipp, bw_full)):
            ipp -= 1
        return nw * ipp, bw_full, 1
    for d in (d for d in range(nw, 0, -1) if nw % d == 0):
        tile = min(bw_full, d)
        if fits(d, tile):
            return d, tile, (nw // d if bw_full > 1 else 1)
    return None


def fused_block_train_fits(nw, n, c, nh, hidden, es=2, softmax="") -> bool:
    """``block_train.fused_block_train_fits``: some window chunk fits the
    training budget (bf16 only; worst case, a per-window bias)."""
    return es == 2 and chunk_geometry(nw, nw, n, c, nh, hidden, es, nw, 1,
                                      softmax) is not None


# ------------------------------------------------------------------------
# The plain version and the kernels
# ------------------------------------------------------------------------


def block_train_kernel_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the single-block train kernels take this block geometry:
    the forward's, the token-parallel forward's at up to ``FAST_MAX_C``
    channels (``token_kernel_supports``); the backward takes the same
    geometries."""
    return token_kernel_supports(n, c, nh, hidden)


def block_train_reference(x_windows, p: FastParams, bias, dp_cols=None, *,
                          num_heads: int, softmax: str):
    """Plain PyTorch version (``_block_ops``): bf16 window-layout tokens,
    folded params, packed bias, optional (B*nW*N, 2) float32 factor
    columns; returns bf16. Differentiable."""
    dpf = None if dp_cols is None else (dp_cols[:, 0].float(),
                                        dp_cols[:, 1].float())
    return fast_body(x_windows.float(), p, bias, num_heads=num_heads,
                     softmax=softmax, dpf=dpf).to(BF16)


def _rb(v):
    """Round float32 to bf16 and back."""
    return v.to(BF16).float()


def _hilo(v):
    """A float32 operand as the kernel takes it: bf16 hi + bf16 lo,
    lo = bf16(v - hi), summed (exactly) in float32."""
    hi = _rb(v)
    return hi + _rb(v - hi)


def _gelu_grad(u):
    """d/du of ``gelu_tanh``."""
    k0, k1 = 0.7978845608028654, 0.044715
    t = torch.tanh(k0 * (u + k1 * u * u * u))
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * k0 * (
        1.0 + 3.0 * k1 * u * u)


def _normalize_bwd(x, dn):
    """The VJP of ``normalize`` at x for the output cotangent dn."""
    mu = x.mean(dim=-1, keepdim=True)
    ex2 = (x * x).mean(dim=-1, keepdim=True)
    a = torch.rsqrt(torch.clamp(ex2 - mu * mu, min=0.0) + 1e-5)
    xh = x * a - mu * a
    return a * (dn - dn.mean(dim=-1, keepdim=True)
                - xh * (dn * xh).mean(dim=-1, keepdim=True))


def block_bwd_reference(x, dz, p: FastParams, bias, dpf=None, *,
                        num_heads: int, softmax: str):
    """The block's backward by hand, in the phases and at the bf16
    rounding points of ``csrc/block_bwd.cuh`` (no autograd): bf16 tokens
    x and output cotangent dz (T, N, C), folded params, packed bias (bw,
    N, nH*N), optional (T*N, 2) float32 factor columns. Returns (dx bf16,
    the grads of p as float32 FastParams, dbias float32 (bw, N, nH*N)).

    Where the kernel takes a float32 operand of a product as bf16 hi +
    lo, so does this (``_hilo``); bias gradients are column sums of the
    same operands (the kernel's ones rows)."""
    code = softmax_code(softmax)
    t, n, c = x.shape
    nh = num_heads
    hd = c // nh
    tn = t * n
    f32 = torch.float32
    xf = x.float().reshape(tn, c)
    dzf = dz.float().reshape(tn, c)
    if dpf is None:
        fa = fm = torch.ones(tn, 1, dtype=f32, device=x.device)
    else:
        fa, fm = dpf[:, 0:1].float(), dpf[:, 1:2].float()
    w = [a.float() for a in p]
    wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2 = w

    def heads(u):  # (T*N, C) -> (T, nH, N, hd)
        return u.reshape(t, n, nh, hd).transpose(1, 2)

    def merge(u):  # (T, nH, N, hd) -> (T*N, C)
        return u.transpose(1, 2).reshape(tn, c)

    # the forward, recomputed: LN1 and qkv; attention; proj, residual and
    # LN2; fc1
    xn = _rb(normalize(xf))
    qkv = _rb(xn @ wqkv + bqkv)
    q, k, v = (heads(qkv[:, i * c:(i + 1) * c]) for i in range(3))
    bw = bias.shape[0]
    bh = bias.float().reshape(bw, n, nh, n).permute(0, 2, 1, 3)
    s = (q @ k.transpose(-2, -1)).reshape(t // bw, bw, nh, n, n) + bh[None]
    s = s.reshape(t, nh, n, n)
    smax = s.amax(dim=-1, keepdim=True)
    if code == SOFTMAX_CODES["clamp"]:
        e = torch.exp(torch.clamp(s, max=60.0))
    else:
        m = _rb(smax) if code == SOFTMAX_CODES["stable_mm"] else smax
        e = torch.exp(s - m)
    pe = _rb(e)
    den = _rb(pe.sum(dim=-1, keepdim=True))
    o = (pe @ v) / den
    ao = _rb(merge(o))
    x1 = xf + (ao @ wproj + bproj) * fa
    x1n = _rb(normalize(x1))
    u = x1n @ w1 + bf1
    h1 = _rb(gelu_tanh(u))
    # the MLP's VJP: fc2, then fc1 through the GELU
    dh2 = _hilo(fm * dzf)
    g_w2, g_bf2 = h1.t() @ dh2, dh2.sum(0)
    du = _hilo(_rb(dh2 @ w2.t()) * _gelu_grad(u))
    g_w1, g_bf1 = x1n.t() @ du, du.sum(0)
    # LN2's VJP and the residual; the projection's VJP
    g2 = dzf + _normalize_bwd(x1, _rb(du @ w1.t()))
    dy = _hilo(fa * g2)
    g_wproj, g_bproj = ao.t() @ dy, dy.sum(0)
    do = heads(_rb(dy @ wproj.t()))
    # attention's VJP per head
    dden = _rb(-(do * o).sum(dim=-1, keepdim=True) / den)
    da = _hilo(do / den)
    dv = _rb(pe.transpose(-2, -1) @ da)
    ds = _rb(_rb(da @ v.transpose(-2, -1)) + dden) * e
    if code == SOFTMAX_CODES["clamp"]:
        ds = torch.where(s > 60.0, torch.zeros_like(ds), ds)
    else:
        tie = (s == smax).to(f32)
        dm = -ds.sum(dim=-1, keepdim=True)
        if code == SOFTMAX_CODES["stable_mm"]:
            dm = _rb(dm)
        ds = ds + tie * (dm / tie.sum(dim=-1, keepdim=True))
    dsh = _hilo(ds)
    dq = _rb(dsh @ k)
    dk = _rb(dsh.transpose(-2, -1) @ q)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=1)
    g_wqkv, g_bqkv = xn.t() @ dqkv, dqkv.sum(0)
    # LN1's VJP and the residual
    dx = g2 + _normalize_bwd(xf, _rb(dqkv @ wqkv.t()))
    # the score cotangents in the packed layout, summed per bias window
    dsw = ds.permute(0, 2, 1, 3).reshape(t // bw, bw, n, nh * n)
    grads = FastParams(g_wqkv, g_bqkv, g_wproj, g_bproj, g_w1, g_bf1, g_w2,
                       g_bf2)
    return dx.reshape(t, n, c).to(BF16), grads, dsw.sum(0)


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_rdst_sizes", False):
        lib.block_train_work_floats.argtypes = [ctypes.c_int] * 5
        lib.block_train_work_floats.restype = ctypes.c_longlong
        lib.block_train_bwd_kernels.argtypes = []
        lib.block_train_bwd_kernels.restype = ctypes.c_int
        lib._rdst_sizes = True
    return lib


# The forward's scratch between its phases, one buffer per (device,
# geometry), kept for the process: each step's calls reuse it (they run in
# order on one stream), so a step allocates none.
_fwd_work = {}


def forward_layout(p: FastParams, nh: int):
    """The forward kernels' weights (``token_wgmma_layout``)."""
    return token_wgmma_layout(token_layout(p, nh))


def launch_forward(x, layout, bias, dpf, nh: int, hidden: int, code: int):
    """Launch ``block_train_fwd_bf16`` (the token-parallel forward, five
    kernels) with the block's weights as :func:`forward_layout` lays them
    out; returns the output tokens."""
    t, n, c = x.shape
    dims = [t, n, c, nh, hidden, bias.shape[0], code]
    lib = _lib()
    key = (x.device, t, n, c, nh, hidden)
    work = _fwd_work.get(key)
    if work is None:
        work = torch.empty(work_bytes(lib, "block_train_fwd_work_bytes",
                                      dims), dtype=torch.uint8,
                           device=x.device)
        _fwd_work[key] = work
    out = torch.empty_like(x)
    launch(lib, "block_train_fwd_bf16",
           [x, out, 0 if dpf is None else dpf, *layout, bias, work], dims,
           x.device)
    launch_forward.launches += 1
    return out


launch_forward.launches = 0  # wrapper calls since the last reset


def split_grads(flat, like: FastParams) -> FastParams:
    """Views of a flat gradient buffer in FastParams order and shapes."""
    out, at = [], 0
    for a in like:
        out.append(flat[at:at + a.numel()].view(a.shape))
        at += a.numel()
    return FastParams(*out)


def launch_backward(x, dz, p: FastParams, bias, dpf, nh: int, code: int):
    """Launch ``block_train_bwd_bf16`` (13 kernels); returns (dx bf16, the
    grads of p as float32 FastParams, dbias float32)."""
    t, n, c = x.shape
    hidden = p.w1.shape[1]
    dev = x.device
    lib = _lib()
    work = torch.empty(lib.block_train_work_floats(t, n, c, nh, hidden),
                       dtype=torch.float32, device=dev)
    grads = torch.empty(sum(a.numel() for a in p), dtype=torch.float32,
                        device=dev)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    launch(lib, "block_train_bwd_bf16",
           [x, dz, dx, 0 if dpf is None else dpf, work, grads, dbias,
            *[a.contiguous() for a in p], bias],
           [t, n, c, nh, hidden, bias.shape[0], code], dev)
    launch_backward.launches += 1
    launch_backward.reductions += lib.block_train_bwd_kernels() - 1
    return dx, split_grads(grads, p), dbias


launch_backward.launches = 0  # wrapper calls since the last reset
# the backward's kernels other than the attention VJP, since the last reset
launch_backward.reductions = 0


class BlockTrainFunction(torch.autograd.Function):
    """The block on the card: forward and backward are the CUDA kernels.
    Inputs: tokens, factor columns (or None), (heads, softmax code), then
    the 8 folded tensors and the packed bias. Gradients come back in each
    input's dtype, as the JAX kernel casts them; the factor columns get
    none."""

    @staticmethod
    def forward(ctx, x, dpf, geom, *tensors):
        nh, code = geom
        p, bias = FastParams(*tensors[:8]), tensors[8]
        out = launch_forward(x, forward_layout(p, nh), bias, dpf, nh,
                             p.w1.shape[1], code)
        ctx.geom = geom
        ctx.has_dpf = dpf is not None
        ctx.save_for_backward(x, *(() if dpf is None else (dpf,)), *tensors)
        return out

    @staticmethod
    def backward(ctx, dz):
        saved = ctx.saved_tensors
        x = saved[0]
        dpf = saved[1] if ctx.has_dpf else None
        tensors = saved[2 if ctx.has_dpf else 1:]
        p, bias = FastParams(*tensors[:8]), tensors[8]
        dx, gp, db = launch_backward(x, dz.contiguous(), p, bias, dpf,
                                     *ctx.geom)
        cast = [g.to(a.dtype) for g, a in zip(gp, p)] + [db.to(bias.dtype)]
        return (dx, None, None, *cast)


def run_block_train(x_windows, p: FastParams, bias, dp_cols=None, *,
                    num_heads: int, windows_per_image: int,
                    softmax: str = ""):
    """The differentiable block on bf16 window-layout tokens (B*nW, N, C)
    with folded params (``FastParams``) and a packed bias (1 or nW, N,
    nH*N). A CPU tensor takes :func:`block_train_reference`; a CUDA
    tensor the kernels."""
    nh, nw = num_heads, windows_per_image
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    hidden = p.w1.shape[-1]
    code = softmax_code(softmax)
    if not block_train_kernel_supports(n, c, nh, hidden):
        raise ValueError(
            f"fused_swin_block_train: the CUDA kernels do not take N={n}, "
            f"C={c}, heads={nh}, hidden={hidden} (needs N a multiple of 16 "
            f"up to 64, C <= {FAST_MAX_C}, head dim <= 32, hidden <= 512 "
            f"and {token_smem_bytes(n, c, nh, hidden)} <= {H100_SMEM_OPTIN} "
            "bytes of shared memory); build with pallas_train='off'")
    if (bias.dim() != 3 or bias.shape[0] not in (1, nw)
            or tuple(bias.shape[1:]) != (n, nh * n)
            or p.wqkv.shape[0] != c):
        raise ValueError(f"params (C={p.wqkv.shape[0]}, bias "
                         f"{tuple(bias.shape)}) do not fit C={c}, {nh} "
                         f"heads, {nw} windows per image")
    if t % nw:
        raise ValueError(f"{t} windows are not whole images of {nw}")
    check_fast_tokens("x_windows", x_windows, (t, n, c))
    if dp_cols is not None and (tuple(dp_cols.shape) != (t * n, 2)
                                or dp_cols.dtype != torch.float32):
        raise ValueError(f"dp_cols must be float32 ({t * n}, 2), got "
                         f"{dp_cols.dtype} {tuple(dp_cols.shape)}")
    dev = x_windows.device
    if bias.device != dev or p.wqkv.device != dev:
        raise ValueError(f"params are on {p.wqkv.device}, x_windows on {dev}")
    if dev.type == "cpu":
        return block_train_reference(x_windows, p, bias, dp_cols,
                                     num_heads=nh, softmax=softmax)
    dpf = None if dp_cols is None else dp_cols.detach().contiguous()
    return BlockTrainFunction.apply(x_windows, dpf, (nh, code), *p,
                                    bias.contiguous())


def fused_swin_block_train(x_windows, params, bias, dp_cols=None, *,
                           num_heads: int, windows_per_image: int,
                           softmax: str = ""):
    """The JAX function's contract: ``params`` the block's 12-param
    bundle (weights (in, out), LN affines, float32 masters), ``bias``
    (nH, N, N) shared or (nH*nW, N, N) per window; folded and packed here
    in plain torch (differentiable), then :func:`run_block_train`."""
    c, nh = params[0].shape[0], num_heads
    return run_block_train(
        x_windows, fast_params(params, c, nh),
        pack_bias_fast(bias, nh, bias.shape[-1]), dp_cols, num_heads=nh,
        windows_per_image=windows_per_image, softmax=softmax)
