"""The token-parallel forward's GEMMs one at a time: the CUDA kernels of
``csrc/token_wgmma.cuh`` and their plain PyTorch versions.

The fast block above ``WINDOW_MAX_C`` and the pair and RDSTB stages that
``stage_route`` sends to the token-parallel forward run these four
products inside their calls (``csrc/token_fwd.cuh``); they are not entry
points of the model. Each function here launches one of them alone on
token-major buffers, as the forward keeps them, so that ``chip_smoke.py``
can hold each against its plain version and time it beside its byte floor
and a library product of the same shapes:

* :func:`qkv_gemm`: q/k/v by head from the LN1 rows, bf16 or int8 (wgmma
  .s8, exact int32 sums, then ``bf16(float(sum) * ws + bqkv)`` with each
  product and sum rounded on its own);
* :func:`proj_ln`: the projection, its residual and LN2 (one-pass
  moments): x1 (float32) and x1n (bf16, ones at column C); the kernels
  keep x1 in their accumulator order (:func:`x1_pack`), which these
  wrappers convert from and to (T, C);
* :func:`mlp`: fc1, the tanh GELU, fc2 and the residual in one kernel
  whose hidden rows stay in shared memory;
* :func:`adapter`: the RDSTB's tail adapter, its LN (two-pass moments)
  post-norm, nothing pre-norm.

Rows are (tokens, ld) with K = C: columns past C are never read. Weights
are K-major, [n][k], as ``token_wgmma_layout`` and ``qkv_token_layout``
lay them out. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel (``csrc/swin_block_fast.cu``'s ``tokwg_*`` entries)
or raises. Each counts its launches in ``.launches``.
:func:`token_block_staged` chains the four plain versions (with LN1 and
the attention) into one block over the kernels' buffer layouts, the
oracle that ties them to the block's plain version and the JAX kernel.
"""

from __future__ import annotations

import torch

from rdst_tpu_torch.kernels import _build
from rdst_tpu_torch.kernels.quant import QX, quant_rows
from rdst_tpu_torch.kernels.swin_block import (_EPS, BF16, FAST_MAX_C,
                                               fast_attention, gelu_tanh,
                                               launch, normalize,
                                               softmax_code)

_SOURCE = "swin_block_fast.cu"


def _on_card(*tensors) -> bool:
    devs = {t.device.type for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1 or devs - {"cpu", "cuda"}:
        raise ValueError(f"operands on {sorted(devs)}: expected one of cpu "
                         "or cuda")
    return devs == {"cuda"}


def _width(c: int) -> None:
    if not 0 < c <= FAST_MAX_C:
        raise ValueError(f"C={c}: the token-parallel GEMMs take C up to "
                         f"{FAST_MAX_C}")


def _rows(bm: int) -> int:
    if bm not in (0, 64, 128):
        raise ValueError(f"bm={bm}: tiles of 64 or 128 rows (0: the "
                         "schedule's)")
    return bm


def qkv_gemm_reference(a, w, bqkv, ws=None, *, c: int):
    """q/k/v rows (tokens, n3) bf16 from rows a (tokens, ld) and weights w
    (n3, ld), K = c. int8 (``ws`` given): the exact integer sums (float64
    products of int8 values round nowhere below 2^53), then
    ``bf16(float32(sum) * ws + bqkv)``, each step rounded to float32 on
    its own; bf16: ``bf16(a w^T + bqkv)`` with float32 sums."""
    if ws is not None:
        acc = (a[:, :c].double() @ w[:, :c].double().t()).float()
        return ((acc * ws) + bqkv).to(BF16)
    return (a[:, :c].float() @ w[:, :c].float().t() + bqkv).to(BF16)


def qkv_gemm(a, w, bqkv, ws=None, *, c: int, bm: int = 0):
    """The qkv product (:func:`qkv_gemm_reference`) on the card, or its
    plain version for CPU tensors. ``bm``: the card's tile rows (64 or
    128; 0: the schedule's own, ``token_tile_rows``), for timing both."""
    _width(c)
    t, ld = a.shape
    n3 = w.shape[0]
    if (a.dtype != (torch.int8 if ws is not None else BF16)
            or w.dtype != a.dtype or w.shape[1] != ld or ld < c):
        raise ValueError(f"qkv_gemm: rows {a.dtype} {tuple(a.shape)}, "
                         f"weights {w.dtype} {tuple(w.shape)}, C={c}")
    if not _on_card(a, w, bqkv, ws):
        return qkv_gemm_reference(a, w, bqkv, ws, c=c)
    out = torch.empty(t, n3, dtype=BF16, device=a.device)
    launch(_build.load(_SOURCE), "tokwg_qkv",
           [a, w, ws if ws is not None else 0, bqkv, out],
           [t, c, n3, ld, _rows(bm)], a.device)
    qkv_gemm.launches += 1
    return out


qkv_gemm.launches = 0


def x1_pack(x1):
    """x1 (tokens, C) float32 in the order the projection's and the MLP's
    kernels keep it between them (``tokwg::x1_at``): per block of 16 rows
    and 64-column piece, (8-column group, row half, lane, pair), so that
    a warp moves 256 contiguous bytes at a time; rows to 16 and columns
    to 64 padded with zeros. Returns the flat float32 buffer."""
    t, c = x1.shape
    pc, tp = -(-c // 64), -(-t // 16) * 16
    buf = x1.new_zeros(tp, 64 * pc)
    buf[:t, :c] = x1
    return buf.view(tp // 16, 2, 8, pc, 8, 4, 2).permute(
        0, 3, 4, 1, 2, 5, 6).reshape(-1)


def x1_unpack(flat, tokens: int, c: int):
    """The inverse of :func:`x1_pack`: (tokens, C) float32."""
    pc, tp = -(-c // 64), -(-tokens // 16) * 16
    return flat.view(tp // 16, pc, 8, 2, 8, 4, 2).permute(
        0, 3, 4, 1, 2, 5, 6).reshape(tp, 64 * pc)[:tokens, :c]


def proj_ln_reference(ao, wproj, x, bproj, dpf=None, *, c: int):
    """x1 = x + (ao Wproj^T + bproj) f (float32, K = N = c; f the
    attention column of the (T, 2) factor columns ``dpf``, or 1) and x1n
    = bf16(normalize(x1)) with ones at column c and zeros to kp."""
    t, kp = ao.shape
    y = ao[:, :c].float() @ wproj[:c, :c].float().t() + bproj.float()
    if dpf is not None:
        y = y * dpf[:, 0:1]
    x1 = x.float() + y
    x1n = torch.zeros(t, kp, dtype=BF16, device=ao.device)
    x1n[:, :c] = normalize(x1).to(BF16)
    x1n[:, c] = 1.0
    return x1, x1n


def proj_ln(ao, wproj, x, bproj, *, c: int, bm: int = 0):
    """The projection + residual + LN2 (:func:`proj_ln_reference`) on the
    card, or its plain version for CPU tensors; ``bm`` as
    :func:`qkv_gemm`'s."""
    _width(c)
    t, kp = ao.shape
    if (tuple(wproj.shape) != (kp, kp) or tuple(x.shape) != (t, c)
            or kp <= c):
        raise ValueError(f"proj_ln: ao {tuple(ao.shape)}, wproj "
                         f"{tuple(wproj.shape)}, x {tuple(x.shape)}, C={c}")
    if not _on_card(ao, wproj, x, bproj):
        return proj_ln_reference(ao, wproj, x, bproj, c=c)
    x1 = torch.empty(-(-t // 16) * 16 * 64 * -(-c // 64),
                     dtype=torch.float32, device=ao.device)
    x1n = torch.empty(t, kp, dtype=BF16, device=ao.device)
    launch(_build.load(_SOURCE), "tokwg_proj_ln",
           [ao, wproj, x, bproj, x1, x1n], [t, c, kp, _rows(bm)], ao.device)
    proj_ln.launches += 1
    return x1_unpack(x1, t, c), x1n


proj_ln.launches = 0


def mlp_reference(x1n, w1, w2, bf1, x1, bf2, dpf=None, *, c: int,
                  hidden: int):
    """out = bf16(x1 + (h W2^T + bf2) f) with h = bf16(gelu_tanh(x1n W1^T
    + bf1)): K = c for fc1, hidden for fc2, float32 sums; f the MLP column
    of the (T, 2) factor columns ``dpf``, or 1."""
    h = gelu_tanh(x1n[:, :c].float() @ w1[:hidden, :c].float().t()
                  + bf1).to(BF16)
    y = h.float() @ w2[:c, :hidden].float().t() + bf2.float()
    if dpf is not None:
        y = y * dpf[:, 1:2]
    return (x1 + y).to(BF16)


def mlp(x1n, w1, w2, bf1, x1, bf2, *, c: int, hidden: int, bm: int = 0):
    """fc1 + GELU + fc2 + residual (:func:`mlp_reference`) on the card in
    one kernel, or its plain version for CPU tensors; ``bm`` as
    :func:`qkv_gemm`'s."""
    _width(c)
    t, kp = x1n.shape
    hp = w1.shape[0]
    if (tuple(w1.shape) != (hp, kp) or tuple(w2.shape) != (kp, hp)
            or tuple(x1.shape) != (t, c) or not 0 < hidden <= min(hp, 512)):
        raise ValueError(f"mlp: x1n {tuple(x1n.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, x1 "
                         f"{tuple(x1.shape)}, C={c}, hidden={hidden}")
    if not _on_card(x1n, w1, w2, bf1, x1, bf2):
        return mlp_reference(x1n, w1, w2, bf1, x1, bf2, c=c, hidden=hidden)
    out = torch.empty(t, c, dtype=BF16, device=x1n.device)
    launch(_build.load(_SOURCE), "tokwg_mlp",
           [x1n, w1, w2, bf1, x1_pack(x1.float()), bf2, out],
           [t, c, hidden, kp, hp, _rows(bm)], x1n.device)
    mlp.launches += 1
    return out


mlp.launches = 0


def adapter_reference(z, w, bad, gad, bbad, *, c: int, prenorm: bool):
    """a = z w^T + bad (K = c, float32 sums); pre-norm bf16(a), post-norm
    bf16(LN(a) gad + bbad) with two-pass moments, eps 1e-5."""
    a = z[:, :c].float() @ w[:, :c].float().t() + bad
    if prenorm:
        return a.to(BF16)
    mu = a.mean(dim=-1, keepdim=True)
    d = a - mu
    rs = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + _EPS)
    return (d * rs * gad + bbad).to(BF16)


def adapter(z, w, bad, gad, bbad, *, c: int, prenorm: bool):
    """The RDSTB adapter (:func:`adapter_reference`) on the card, or its
    plain version for CPU tensors; returns (tokens, growth) bf16."""
    _width(c)
    t, ldz = z.shape
    growth = w.shape[0]
    if w.shape[1] != ldz or ldz < c or not 0 < growth <= 256:
        raise ValueError(f"adapter: z {tuple(z.shape)}, w {tuple(w.shape)},"
                         f" C={c}")
    if not _on_card(z, w, bad, gad, bbad):
        return adapter_reference(z, w, bad, gad, bbad, c=c, prenorm=prenorm)
    out = torch.empty(t, growth, dtype=BF16, device=z.device)
    launch(_build.load(_SOURCE), "tokwg_adapter",
           [z, w, bad, gad, bbad, out], [t, c, ldz, growth, int(prenorm)],
           z.device)
    adapter.launches += 1
    return out


adapter.launches = 0


def token_block_staged(x_windows, layout, qkv_layout, bias, dpf=None, *,
                       num_heads: int, softmax: str):
    """One block of the token-parallel forward phase by phase on the plain
    versions above, over the kernels' buffers: bf16 tokens (T, N, C), the
    weights as ``token_wgmma_layout`` lays them out, the int8 qkv
    operands of ``qkv_token_layout`` (or ``()``), the packed (bw, N,
    nH*N) bias, and for the training step's block (``csrc/block_train
    .cu``) its (T*N, 2) float32 factor columns ``dpf``. LN1 rows (bf16, or
    int8 kq wide), :func:`qkv_gemm`'s, the attention of
    ``swin_block.fast_attention`` (an exact division, the training
    forward's; the serving forward's approximate reciprocal is within
    its bar) on each head's first hd of its hdg channels, its rows kp
    wide with ones at column C, :func:`proj_ln`'s and :func:`mlp`'s;
    returns bf16 (T, N, C)."""
    t, n, c = x_windows.shape
    nh = num_heads
    hd = c // nh
    wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2 = layout
    n3, kp = wqkv.shape
    hidden = bf1.shape[0]
    x = x_windows.reshape(t * n, c)
    xf = normalize(x.float())
    if qkv_layout:
        wq, ws = qkv_layout
        rows = torch.zeros(t * n, wq.shape[1], dtype=torch.int8,
                           device=x.device)
        rows[:, :c] = quant_rows(xf, QX)
        qkv = qkv_gemm_reference(rows, wq, bqkv, ws, c=c)
    else:
        rows = torch.zeros(t * n, kp, dtype=BF16, device=x.device)
        rows[:, :c] = xf.to(BF16)
        qkv = qkv_gemm_reference(rows, wqkv, bqkv, c=c)
    q, k, v = qkv.reshape(t, n, 3, nh, n3 // (3 * nh))[..., :hd].permute(
        2, 0, 3, 1, 4)
    o = fast_attention(q, k, v, bias, softmax_code(softmax))
    ao = torch.zeros(t * n, kp, dtype=BF16, device=x.device)
    ao[:, :c] = o.transpose(1, 2).reshape(t * n, c).to(BF16)
    ao[:, c] = 1.0
    x1, x1n = proj_ln_reference(ao, wproj, x, bproj, dpf, c=c)
    return mlp_reference(x1n, w1, w2, bf1, x1, bf2, dpf, c=c,
                         hidden=hidden).reshape(t, n, c)
