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
``block_train_fwd_bf16`` and whose backward ``block_train_bwd_bf16`` of
``csrc/block_train.cu`` (the VJP kernel, then two reduction kernels),
each wrapper call counted (``launch_forward.launches``,
``launch_backward.launches``; ``launch_backward.reductions`` counts the
reduction kernels apart). What the kernels do not take raises on either
device; on the card nothing falls back to the plain version.

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
    BF16, FAST_MAX_C, H100_SMEM_OPTIN, FastParams, check_fast_tokens,
    fast_body, fast_kernel_supports, fast_params, fast_smem_bytes,
    kernel_layout, launch, pack_bias_fast, softmax_code)

_SOURCE = "block_train.cu"
_MAX_GRID = 1024  # thread blocks of one backward launch (one window each)

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
    the forward's window body at up to ``FAST_MAX_C`` channels; the
    backward keeps its per-window state in device memory."""
    return fast_kernel_supports(n, c, nh, hidden, max_c=FAST_MAX_C)


def block_train_reference(x_windows, p: FastParams, bias, dp_cols=None, *,
                          num_heads: int, softmax: str):
    """Plain PyTorch version (``_block_ops``): bf16 window-layout tokens,
    folded params, packed bias, optional (B*nW*N, 2) float32 factor
    columns; returns bf16. Differentiable."""
    dpf = None if dp_cols is None else (dp_cols[:, 0].float(),
                                        dp_cols[:, 1].float())
    return fast_body(x_windows.float(), p, bias, num_heads=num_heads,
                     softmax=softmax, dpf=dpf).to(BF16)


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_rdst_sizes", False):
        lib.block_train_work_floats.argtypes = [ctypes.c_int] * 4
        lib.block_train_work_floats.restype = ctypes.c_int
        lib.block_train_grad_floats.argtypes = [ctypes.c_int] * 2
        lib.block_train_grad_floats.restype = ctypes.c_int
        lib._rdst_sizes = True
    return lib


def launch_forward(x, layout, bias, dpf, nh: int, hidden: int, code: int):
    """Launch ``block_train_fwd_bf16`` with the block's weights in the
    kernels' layout (``kernel_layout``); returns the output tokens."""
    t, n, c = x.shape
    out = torch.empty_like(x)
    launch(_lib(), "block_train_fwd_bf16",
           [x, out, 0 if dpf is None else dpf, *layout, bias],
           [t, n, c, nh, hidden, bias.shape[0], code], x.device)
    launch_forward.launches += 1
    return out


launch_forward.launches = 0  # wrapper calls (kernel launches) since reset


def launch_backward(x, dz, p: FastParams, bias, dpf, nh: int, code: int):
    """Launch ``block_train_bwd_bf16`` (the VJP kernel and its two
    reductions); returns (dx bf16, the grads of p as float32 FastParams,
    dbias float32)."""
    t, n, c = x.shape
    hidden = p.w1.shape[1]
    dev = x.device
    lib = _lib()
    grid = min(t, _MAX_GRID)
    work = torch.empty(grid * lib.block_train_work_floats(n, c, nh, hidden),
                       dtype=torch.float32, device=dev)
    gsize = lib.block_train_grad_floats(c, hidden)
    slab = torch.zeros(grid, gsize, dtype=torch.float32, device=dev)
    dsw = torch.empty(t, n, nh * n, dtype=torch.float32, device=dev)
    grads = torch.empty(gsize, dtype=torch.float32, device=dev)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    launch(lib, "block_train_bwd_bf16",
           [x, dz, dx, 0 if dpf is None else dpf, work, slab, dsw, grads,
            dbias, *[a.contiguous() for a in p], bias],
           [t, n, c, nh, hidden, bias.shape[0], code, grid], dev)
    launch_backward.launches += 1
    launch_backward.reductions += 2
    out, at = [], 0
    for a in p:
        out.append(grads[at:at + a.numel()].view(a.shape))
        at += a.numel()
    return dx, FastParams(*out), dbias


launch_backward.launches = 0  # wrapper calls (VJP kernel launches)
launch_backward.reductions = 0  # reduction kernel launches, counted apart


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
        out = launch_forward(x, kernel_layout(p), bias, dpf, nh,
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
            f"up to 64, C <= {FAST_MAX_C}, head dim <= 32 and "
            f"{fast_smem_bytes(n, c, nh, hidden)} <= {H100_SMEM_OPTIN} bytes "
            "of shared memory); build with pallas_train='off'")
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
