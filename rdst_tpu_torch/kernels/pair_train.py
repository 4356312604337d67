"""The differentiable DSTL pair of the bf16 training step: the CUDA
forward and backward kernels and their plain PyTorch version.

Counterpart of ``rdst_tpu/kernels/pair_train.py::fused_swin_pair_train``:
the pair of ``kernels.swin_pair`` (block a unshifted, the relayout,
block b shifted; unshifted window layout in, SHIFTED window layout out)
with the two training differences of the JAX kernel: an exact division
of the softmax normalizer, and optional stochastic-depth factor columns
``dp_factors`` (B*nW*N, 4) = [attn_a, mlp_a, attn_b, mlp_b] on the
residual branches.

Folding (``prep_block_params``, ``pack_bias_fast``) stays outside the
kernels in plain torch, so autograd carries the folded gradients back to
the raw parameters, the LayerNorm affines and the relative-position
table. On a CPU tensor :func:`run_pair_train` computes
:func:`pair_train_reference` (autograd differentiates it); on a CUDA
tensor it applies :class:`PairTrainFunction`, whose forward launches
``pair_train_fwd_bf16`` and whose backward launches
``pair_train_bwd_bf16`` of ``csrc/pair_train.cu`` (block b's backward,
then block a's: 13 kernels each, one of them the attention VJP), each
wrapper call counted (``launch_forward.launches``,
``launch_backward.launches``; ``launch_backward.reductions`` counts the
backward's kernels other than the two attention VJPs). What the kernels
do not take raises on either device; on the card nothing falls back to
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.block_train import split_grads
from rdst_tpu_torch.kernels.swin_block import (
    BF16, H100_SMEM_OPTIN, SHARED_MAX_C, FastParams, check_fast_tokens,
    fast_body, fast_kernel_supports, fast_params, fast_smem_bytes,
    kernel_layout, launch, pack_bias_fast, softmax_code)
from rdst_tpu_torch.kernels.swin_pair import shift_relayout

_SOURCE = "pair_train.cu"


def pair_train_kernel_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the train-pair kernels take this block geometry: the
    forward's window body (``fast_kernel_supports``); the backward takes
    the same geometries."""
    return fast_kernel_supports(n, c, nh, hidden)


def pair_train_reference(x_windows, pa: FastParams, bias_a, pb: FastParams,
                         bias_b, dp_factors=None, *, num_heads: int, x_size,
                         window_size: int, shift: int, softmax: str):
    """Plain PyTorch version (``_pair_ops``): bf16 tokens in unshifted
    window layout, folded params and packed biases of both blocks,
    optional (B*nW*N, 4) float32 factor columns; returns bf16 tokens in
    shifted window layout. Differentiable."""
    dpf = None if dp_factors is None else dp_factors.float()
    cols = (lambda i: (dpf[:, i], dpf[:, i + 1])) if dpf is not None \
        else (lambda i: None)
    y = fast_body(x_windows.float(), pa, bias_a, num_heads=num_heads,
                  softmax=softmax, dpf=cols(0))
    y2 = shift_relayout(y.to(BF16), x_size, window_size, shift)
    z = fast_body(y2.float(), pb, bias_b, num_heads=num_heads,
                  softmax=softmax, dpf=cols(2))
    return z.to(BF16)


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_rdst_sizes", False):
        lib.pair_train_work_floats.argtypes = [ctypes.c_int] * 5
        lib.pair_train_work_floats.restype = ctypes.c_longlong
        lib.pair_train_bwd_kernels.argtypes = []
        lib.pair_train_bwd_kernels.restype = ctypes.c_int
        lib._rdst_sizes = True
    return lib


def _plain(p: FastParams):
    return [t.contiguous() for t in p]


def launch_forward(x, layout_a, bias_a, layout_b, bias_b, dpf, geom,
                   hidden: int):
    """Launch ``pair_train_fwd_bf16`` with both blocks' weights in the
    kernels' layout (``kernel_layout``) and MLP width ``hidden``; returns (out, y): the pair's
    output and block a's bf16 output in image layout, kept for the
    backward."""
    (h, w), ws, shift, nh, code = geom
    t, n, c = x.shape
    nw = (h // ws) * (w // ws)
    out = torch.empty_like(x)
    y = torch.empty(t // nw, h, w, c, dtype=BF16, device=x.device)
    counter = torch.zeros(1, dtype=torch.int32, device=x.device)
    launch(_lib(), "pair_train_fwd_bf16",
           [x, out, y, counter, 0 if dpf is None else dpf, *layout_a, bias_a,
            *layout_b, bias_b],
           [t // nw, h, w, ws, shift, c, nh, hidden, code], x.device)
    launch_forward.launches += 1
    return out, y


launch_forward.launches = 0  # kernel launches since the last reset


def launch_backward(x, dz, y, pa: FastParams, bias_a, pb: FastParams, bias_b,
                    dpf, geom):
    """Launch ``pair_train_bwd_bf16``; returns (dx bf16, grads of pa as
    float32 FastParams, dbias_a, grads of pb, dbias_b)."""
    (h, w), ws, shift, nh, code = geom
    t, n, c = x.shape
    hidden = pa.w1.shape[1]
    dev = x.device
    lib = _lib()
    work = torch.empty(lib.pair_train_work_floats(t, n, c, nh, hidden),
                       dtype=torch.float32, device=dev)
    grads = torch.empty(2, sum(p.numel() for p in pa), dtype=torch.float32,
                        device=dev)
    dbias_a = torch.empty(bias_a.shape, dtype=torch.float32, device=dev)
    dbias_b = torch.empty(bias_b.shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    launch(lib, "pair_train_bwd_bf16",
           [x, dz, y, dx, dy, 0 if dpf is None else dpf, work, grads[0],
            grads[1], dbias_a, dbias_b, *_plain(pa), bias_a, *_plain(pb),
            bias_b],
           [t // (h // ws * (w // ws)), h, w, ws, shift, c, nh, hidden,
            code], dev)
    launch_backward.launches += 1
    launch_backward.reductions += lib.pair_train_bwd_kernels() - 2
    return (dx, split_grads(grads[0], pa), dbias_a,
            split_grads(grads[1], pb), dbias_b)


launch_backward.launches = 0  # wrapper calls since the last reset
# the backward's kernels other than the attention VJPs, since the last reset
launch_backward.reductions = 0


class PairTrainFunction(torch.autograd.Function):
    """The pair on the card: forward and backward are the CUDA kernels.
    Inputs: tokens, factor columns (or None), geometry, then the 8
    folded tensors and the packed bias of each block. Gradients come back
    in each input's dtype, as the JAX kernel casts them; the factor
    columns get none."""

    @staticmethod
    def forward(ctx, x, dpf, geom, *tensors):
        pa, bias_a = FastParams(*tensors[:8]), tensors[8]
        pb, bias_b = FastParams(*tensors[9:17]), tensors[17]
        out, y = launch_forward(x, kernel_layout(pa), bias_a,
                                kernel_layout(pb), bias_b, dpf, geom,
                                pa.w1.shape[1])
        ctx.geom = geom
        ctx.save_for_backward(x, y, *(() if dpf is None else (dpf,)),
                              *tensors)
        ctx.has_dpf = dpf is not None
        return out

    @staticmethod
    def backward(ctx, dz):
        saved = ctx.saved_tensors
        x, y = saved[0], saved[1]
        dpf = saved[2] if ctx.has_dpf else None
        tensors = saved[3 if ctx.has_dpf else 2:]
        pa, bias_a = FastParams(*tensors[:8]), tensors[8]
        pb, bias_b = FastParams(*tensors[9:17]), tensors[17]
        dx, ga, dba, gb, dbb = launch_backward(
            x, dz.contiguous(), y, pa, bias_a, pb, bias_b, dpf, ctx.geom)
        cast = [g.to(p.dtype) for g, p in zip(ga, pa)] + \
            [dba.to(bias_a.dtype)] + \
            [g.to(p.dtype) for g, p in zip(gb, pb)] + [dbb.to(bias_b.dtype)]
        return (dx, None, None, *cast)


def run_pair_train(x_windows, pa: FastParams, bias_a, pb: FastParams, bias_b,
                   dp_factors=None, *, num_heads: int, x_size,
                   window_size: int, shift: int, softmax: str = ""):
    """The differentiable pair on bf16 window-layout tokens (B*nW, N, C)
    with folded params (``FastParams``) and packed biases (block a (1, N,
    nH*N); block b (nW, N, nH*N) when shifted, else (1, ...)). Returns
    (B*nW, N, C) in SHIFTED window layout. A CPU tensor takes
    :func:`pair_train_reference`; a CUDA tensor the kernels."""
    h, w = x_size
    ws, nh = window_size, num_heads
    if x_windows.dim() != 3:
        raise ValueError(f"x_windows must be (B*nW, N, C), got "
                         f"{tuple(x_windows.shape)}")
    t, n, c = x_windows.shape
    hidden = pa.w1.shape[-1]
    code = softmax_code(softmax)
    if (n != ws * ws or h % ws or w % ws or not 0 <= shift < ws
            or pb.w1.shape[-1] != hidden
            or not pair_train_kernel_supports(n, c, nh, hidden)):
        raise ValueError(
            f"fused_swin_pair_train: the CUDA kernels do not take N={n}, "
            f"C={c}, heads={nh}, hidden={hidden}, {h}x{w} with window {ws} "
            f"and shift {shift} (needs whole windows of 16 or 64 tokens, C "
            f"<= {SHARED_MAX_C}, head dim <= 32 and "
            f"{fast_smem_bytes(n, c, nh, hidden)} <= {H100_SMEM_OPTIN} bytes "
            "of shared memory); wider blocks train one at a time "
            "(pallas_train='block', kernels.block_train), or build with "
            "pallas_train='off'")
    nw = (h // ws) * (w // ws)
    if t % nw:
        raise ValueError(f"{t} windows are not whole images of {nw}")
    if (tuple(bias_a.shape) != (1, n, nh * n)
            or tuple(bias_b.shape) != ((nw if shift else 1), n, nh * n)
            or pa.wqkv.shape[0] != c or pb.wqkv.shape[0] != c):
        raise ValueError(f"params (C={pa.wqkv.shape[0]}, {pb.wqkv.shape[0]};"
                         f" biases {tuple(bias_a.shape)}, "
                         f"{tuple(bias_b.shape)}) do not fit C={c}, {nh} "
                         f"heads, {nw} windows, shift {shift}")
    check_fast_tokens("x_windows", x_windows, (t, n, c))
    if dp_factors is not None:
        if (tuple(dp_factors.shape) != (t * n, 4)
                or dp_factors.dtype != torch.float32):
            raise ValueError(f"dp_factors must be float32 ({t * n}, 4), got "
                             f"{dp_factors.dtype} {tuple(dp_factors.shape)}")
    dev = x_windows.device
    if bias_a.device != dev or pa.wqkv.device != dev:
        raise ValueError(f"params are on {pa.wqkv.device}, x_windows on {dev}")
    kw = dict(num_heads=nh, x_size=x_size, window_size=ws, shift=shift,
              softmax=softmax)
    if dev.type == "cpu":
        return pair_train_reference(x_windows, pa, bias_a, pb, bias_b,
                                    dp_factors, **kw)
    dpf = None if dp_factors is None else dp_factors.detach().contiguous()
    return PairTrainFunction.apply(
        x_windows, dpf, ((h, w), ws, shift, nh, code), *pa,
        bias_a.contiguous(), *pb, bias_b.contiguous())


def fused_swin_pair_train(x_windows, params_a, bias_a, params_b, bias_b,
                          dp_factors=None, *, num_heads: int, x_size,
                          window_size: int, shift: int, softmax: str = ""):
    """The JAX function's contract: params_X the 12-param bundles of the
    two blocks (weights (in, out), LN affines, float32 masters), bias_a
    (nH, N, N), bias_b (nH*nW, N, N) when shifted; folded and packed here
    in plain torch (differentiable), then :func:`run_pair_train`."""
    c, nh = params_a[0].shape[0], num_heads
    n = bias_a.shape[-1]
    return run_pair_train(
        x_windows, fast_params(params_a, c, nh),
        pack_bias_fast(bias_a, nh, n), fast_params(params_b, c, nh),
        pack_bias_fast(bias_b, nh, n), dp_factors, num_heads=nh,
        x_size=x_size, window_size=window_size, shift=shift, softmax=softmax)
