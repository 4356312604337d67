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
``pair_train_fwd_bf16`` of ``csrc/pair_train.cu`` (one persistent
launch: the window body of ``csrc/window_body.cuh`` in its training
form, block a's tiles then block b's in one chained walk,
:func:`chained_walk`; its weights laid out by :func:`forward_layout`,
one gather a call through an index made once per geometry) and whose
backward launches ``pair_train_bwd_bf16`` (block b's backward, then
block a's: 13 kernels each, one of them the attention VJP), each wrapper
call counted (``launch_forward.launches``, ``launch_backward.launches``;
``launch_backward.reductions`` counts the backward's kernels other than
the two attention VJPs). What the kernels do not take raises on either
device; on the card nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List, Tuple

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.block_train import split_grads
from rdst_tpu_torch.kernels.swin_block import (
    BF16, FastParams, check_fast_tokens, fast_body, fast_params,
    kernel_layout, launch, pack_bias_fast, softmax_code)
from rdst_tpu_torch.kernels.swin_pair import shift_relayout
from rdst_tpu_torch.kernels.window_body import (
    BODY_MAX_C, body_supports, make_geom, persist_fit, stage_bias,
    stage_layout)

_SOURCE = "pair_train.cu"


def forward_plan(n: int, c: int, nh: int, hidden: int):
    """The forward's shared-memory plan (``wbody::persist_fit(g, 2)``:
    both blocks' epilogue constants, one block's panels resident)."""
    return persist_fit(make_geom(n, c, nh, hidden), 2)


def pair_train_kernel_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the train-pair kernels take this block geometry: what the
    forward's window body takes (``body_supports``) with a plan that fits
    an H100 block (:func:`forward_plan`); the backward takes these
    geometries too."""
    return (body_supports(n, c, nh, hidden)
            and forward_plan(n, c, nh, hidden).smem > 0)


def forward_turns(n: int, c: int, nh: int, hidden: int) -> bool:
    """Whether the forward's warpgroups take the tensor cores in turns:
    where panels stream through the ring (C > 60 at the MLP ratio 2);
    where every panel is resident they run free of them, which measured
    faster in the serving window kernel (PERF.md §7)."""
    return forward_plan(n, c, nh, hidden).nslots > 0


def chained_walk(pairs_a: int, grid: int) -> List[List[Tuple[int, int]]]:
    """The forward's walk, as each thread block runs it: block ``b`` takes
    tile pairs b, b + grid, ... of the 2 * pairs_a pairs, block a's
    (pairs 0 .. pairs_a - 1) before block b's; a pair p is (block, tile
    pair within the block). Per thread block, its (block, pair) in
    order."""
    return [[(0, p) if p < pairs_a else (1, p - pairs_a)
             for p in range(b, 2 * pairs_a, grid)] for b in range(grid)]


def run_vectors(x_size, window_size: int, c: int, shift: int, gw0: int,
                rows: int, y_addr: int = 0):
    """The forward's moves between a tile's rows and y (``for_run_vectors``
    in ``csrc/pair_train.cu``): y is (images, H, W, c) bf16 at byte
    address ``y_addr``, the tile's first window gw0, its rows [0, rows).
    Returns (v, moves): the vector bytes and, for every vector of every
    thread, (byte offset in y, byte offset in the tile's rows). Rows go as
    runs of ws pixels (a window row), rolled by ``shift``, each contiguous
    in y but where it wraps at the image's edge, in vectors that never
    cross a wrap."""
    (h, w), ws, rb = x_size, window_size, 2 * c
    run, nww = ws * rb, w // ws
    nw = (h // ws) * nww
    align = y_addr | run | rb * w | rb * shift
    v = next(b for b in (16, 8, 4, 2) if align % b == 0)
    per = run // v
    moves = []
    for i in range((rows // ws) * per):
        q, off = i // per, (i % per) * v
        gw, wr = gw0 + q // ws, q % ws
        img, wi = gw // nw, gw % nw
        yy = ((wi // nww) * ws + wr + shift) % h
        px = off // rb
        xx = (wi % nww) * ws + shift + px
        xx -= w if xx >= w else 0
        moves.append((((img * h + yy) * w + xx) * rb + off - px * rb,
                      q * run + off))
    return v, moves


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


# the FastParams operands' dtypes, in the order forward_layout reads them
_PARAM_DTYPES = (BF16, torch.float32, BF16, BF16, BF16, torch.float32, BF16,
                 BF16)
# the forward's operands of a block (stage_layout's, then stage_bias) and
# their dtypes
_OPERAND_DTYPES = (BF16, torch.float32, BF16, torch.float32, BF16, BF16)
_WORDS = 64  # each operand starts on 128 bytes
_index_lock = threading.Lock()
_indices: Dict[tuple, tuple] = {}


def _param_shapes(n: int, c: int, nh: int, hidden: int, bw: int):
    return ((c, 3 * c), (3 * c,), (c, c), (c,), (c, hidden), (hidden,),
            (hidden, c), (c,), (bw, n, nh * n))


def layout_index(n: int, c: int, nh: int, hidden: int, bws, device):
    """The forward's weight layout of both blocks as one gather: (index,
    parts, zero). The source is ``zero`` (two zero words on the device),
    then, per block, the 16-bit words of its eight FastParams tensors and
    its packed bias, in order (an f32 value two words); ``index`` picks
    each word of the output, in which each block's
    ``stage_layout(kernel_layout(p))`` operands and its ``stage_bias``
    follow each other, each from a multiple of 64 words; ``parts`` gives
    each operand's (first word, words, dtype). Made once per geometry and
    device (the layout functions run on index tensors) and kept."""
    key = (n, c, nh, hidden, tuple(bws), str(device))
    with _index_lock:
        if key in _indices:
            return _indices[key]
        off, picks, parts, at = 2, [], [], 0
        for bw in bws:
            srcs = []
            for shape, dt in zip(_param_shapes(n, c, nh, hidden, bw),
                                 _PARAM_DTYPES + (BF16,)):
                w = dt.itemsize // 2
                k = math.prod(shape)
                srcs.append(torch.arange(off, off + w * k, w).reshape(shape))
                off += w * k
            lay = stage_layout(kernel_layout(FastParams(*srcs[:8]),
                                             (torch.int64, torch.int64)),
                               c, nh)
            for t, dt in zip((*lay, stage_bias(srcs[8], nh)),
                             _OPERAND_DTYPES):
                t = t.reshape(-1)
                if dt.itemsize == 4:  # a zero pad (0) takes words 0, 1
                    t = torch.stack([t, t + 1], -1).reshape(-1)
                pad = -t.numel() % _WORDS
                picks += [t, t.new_zeros(pad)]
                parts.append((at, t.numel(), dt))
                at += t.numel() + pad
        index = torch.cat(picks).to(device)
        zero = torch.zeros(2, dtype=torch.int16, device=device)
        _indices[key] = (index, tuple(parts), zero)
        return _indices[key]


def _words(t):
    return t.contiguous().view(torch.int16).reshape(-1)


def forward_layout(pa: FastParams, bias_a, pb: FastParams, bias_b,
                   nh: int):
    """The forward's operands of blocks a and b, 6 each:
    ``stage_layout(kernel_layout(p), c, nh)`` (panels, bqkv, bproj, bf1,
    bf2) and ``stage_bias(bias, nh)``, bitwise, made by one concatenation
    and one gather (:func:`layout_index`), outside autograd."""
    n, c, hidden = bias_a.shape[1], pa.wproj.shape[0], pa.w1.shape[1]
    for p in (pa, pb):
        if tuple(t.dtype for t in p) != _PARAM_DTYPES:
            raise ValueError(f"params of dtypes {[t.dtype for t in p]}, "
                             f"expected {_PARAM_DTYPES}")
    index, parts, zero = layout_index(
        n, c, nh, hidden, (bias_a.shape[0], bias_b.shape[0]), pa.wqkv.device)
    with torch.no_grad():
        src = torch.cat([zero] + [_words(t) for t in
                                  (*pa, bias_a, *pb, bias_b)])
        out = src[index]
    ops = [out[at:at + k].view(dt) for at, k, dt in parts]
    return ops[:6], ops[6:]


def launch_forward(x, ops_a, ops_b, dpf, geom, hidden: int, turns=None):
    """Launch ``pair_train_fwd_bf16`` with both blocks' operands
    (:func:`forward_layout`) and MLP width ``hidden``; the warpgroups take
    turns as :func:`forward_turns` says unless ``turns`` is given (False
    only where every panel is resident). Returns (out, y): the pair's
    output and block a's bf16 output in image layout, kept for the
    backward."""
    (h, w), ws, shift, nh, code = geom
    t, n, c = x.shape
    nw = (h // ws) * (w // ws)
    if turns is None:
        turns = forward_turns(n, c, nh, hidden)
    out = torch.empty_like(x)
    y = torch.empty(t // nw, h, w, c, dtype=BF16, device=x.device)
    ready = torch.empty(t // nw, dtype=torch.int32, device=x.device)
    launch(_lib(), "pair_train_fwd_bf16",
           [x, out, y, ready, 0 if dpf is None else dpf, *ops_a, *ops_b],
           [t // nw, h, w, ws, shift, c, nh, hidden, code, int(turns)],
           x.device)
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
        ops_a, ops_b = forward_layout(pa, bias_a, pb, bias_b, geom[3])
        out, y = launch_forward(x, ops_a, ops_b, dpf, geom, pa.w1.shape[1])
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
            f"<= {BODY_MAX_C}, head dim <= 32, hidden <= 512 and the "
            "forward's plan in an H100 block's shared memory); wider "
            "blocks train one at a time (pallas_train='block', "
            "kernels.block_train), or build with pallas_train='off'")
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
