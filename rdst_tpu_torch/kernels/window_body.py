"""The weight layout and shared-memory plan of the window body that the
pair and RDSTB stage kernels run (``csrc/window_body.cuh``).

The body streams a block's weights through a ring of shared-memory slots,
one panel at a time: each GEMM's (out, in) weight, its output rows padded
with zeros to a multiple of 32, is cut into panels of at most 64 output
channels x 256 inputs (N-piece by N-piece, K-piece by K-piece within
one), and each panel is stored in wgmma's no-swizzle core-matrix order:
8 rows x 8 inputs (128 bytes) at a time, the 8-input chunks of one
8-row group next to each other. The panels of a block follow each other
in one buffer in the order the kernel reads them: qkv, proj, fc1, fc2,
then (block b of an RDSTB stage) the adapter. :func:`stage_layout` builds
the buffer from ``kernel_layout``'s arrays and :func:`unpack_stage_layout`
gives them back bitwise. :func:`stage_fit` mirrors the kernel's choice of
warpgroups and ring slots within an H100 block's shared memory.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

ROWS = 64            # tokens of a warpgroup's tile (wgmma M)
PANEL_N = 64         # output channels of a panel
PANEL_K = 256        # input channels of a panel
MAX_SLOTS = 4        # ring slots
CTRL_BYTES = 16 * MAX_SLOTS  # the ring's mbarriers
SMEM_OPTIN = 232448  # bytes of shared memory one H100 block may opt into
CONV_ROWS, CONV_COLS, CONV_SLOTS = 8, 16, 2  # the conv's output tile
WGS = 2              # consumer warpgroups of a stage kernel (wbody::kWgs)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class Geom(NamedTuple):
    """``wbody::Geom``: a block's padded widths (each head's q, k, v and
    attention output in hdq channels)."""
    n: int
    c: int
    nh: int
    hidden: int
    cp: int     # K of qkv and fc1: c to 16
    hp: int     # K of fc2: hidden to 16
    hdq: int    # head dim to 8
    s: int      # head-padded width nh * hdq
    sq: int     # s to 16: K of proj
    aw: int     # width of the A rows: max(cp, sq)
    nq: int     # N of qkv: 3 s to 32
    no: int     # N of proj and fc2: cp to 32
    nf: int     # N of fc1: hp to 32
    ldqkv: int  # q | k | v row stride
    c8: int     # image-layout row width: c to 8


def make_geom(n: int, c: int, nh: int, hidden: int) -> Geom:
    cp, hp = _round_up(c, 16), _round_up(hidden, 16)
    hdq = _round_up(c // nh, 8)
    s = nh * hdq
    sq = _round_up(s, 16)
    nq = _round_up(3 * s, 32)
    return Geom(n, c, nh, hidden, cp, hp, hdq, s, sq, max(cp, sq), nq,
                _round_up(cp, 32), _round_up(hp, 32), nq + 8,
                _round_up(c, 8))


def wg_bytes(g: Geom, ng: int = 0) -> int:
    """A warpgroup's shared memory: the A rows (64 x aw bf16), then the
    largest of the q | k | v rows (64 x ldqkv bf16), the MLP hidden rows
    (64 x hp bf16) and the adapter's f32 rows (64 x ng)."""
    region = max(2 * ROWS * g.ldqkv, 2 * ROWS * g.hp, 4 * ROWS * ng)
    return _round_up(2 * ROWS * g.aw, 128) + _round_up(region, 128)


def gemm_shapes(g: Geom, ng: int = 0) -> List[Tuple[int, int]]:
    """(N, K) of a block's GEMMs in panel order."""
    out = [(g.nq, g.cp), (g.no, g.sq), (g.nf, g.cp), (g.no, g.hp)]
    return out + [(ng, g.cp)] if ng else out


def panel_bytes(nn: int, kk: int) -> int:
    return 2 * min(nn, PANEL_N) * min(kk, PANEL_K)


# the widest C the body takes (``wbody::geom_ok``)
BODY_MAX_C = 128


def body_supports(n: int, c: int, nh: int, hidden: int) -> bool:
    """``wbody::geom_ok``: windows of 16 or 64 tokens, C <= BODY_MAX_C,
    head dim <= 32, hidden <= 512."""
    return (n in (16, 64) and 0 < c <= BODY_MAX_C and nh > 0 and c % nh == 0
            and c // nh <= 32 and 0 < hidden <= 512)


class Fit(NamedTuple):
    nwg: int         # consumer warpgroups a thread block (0: does not fit)
    nslots: int
    slot_bytes: int
    wg_bytes: int
    smem: int        # dynamic shared memory of the launch


def stage_fit(g: Geom, ng: int = 0) -> Fit:
    """``wbody::stage_fit``: the most warpgroups (up to WGS) that leave
    room for at least two ring slots, then up to four slots."""
    wb = wg_bytes(g, ng)
    slot = _round_up(max(panel_bytes(n, k) for n, k in gemm_shapes(g, ng)),
                     128)
    for w in range(WGS, 0, -1):
        s = min((SMEM_OPTIN - CTRL_BYTES - w * wb) // slot, MAX_SLOTS)
        if s >= 2:
            return Fit(w, s, slot, wb, w * wb + s * slot + CTRL_BYTES)
    return Fit(0, 0, slot, wb, 0)


# The persistent window kernels (csrc/swin_block_fast.cu, the train-pair
# forward of csrc/pair_train.cu): two consumer warpgroups, and after the
# ring's barriers 32 bytes for the resident panels' barrier, one a
# warpgroup for its input tiles and the train pair's swap barrier
PERSIST_WGS = 2
PERSIST_CTRL = CTRL_BYTES + 32


def panel_list(g: Geom, ng: int = 0) -> List[Tuple[int, int, int]]:
    """(gemm, byte offset, bytes) of each panel of a block in order
    (``wbody::for_panels``)."""
    out, off = [], 0
    for i, (nn, kk) in enumerate(gemm_shapes(g, ng)):
        for n0 in range(0, nn, PANEL_N):
            for k0 in range(0, kk, PANEL_K):
                b = panel_bytes(nn - n0, kk - k0)
                out.append((i, off, b))
                off += b
    return out


class PersistFit(NamedTuple):
    """``wbody::PFit``: how the persistent kernel fits an H100 block."""
    res: int         # GEMMs resident (a prefix of qkv, proj, fc1, fc2)
    res_panels: int
    res_bytes: int
    nin: int         # input buffers: 2 (one a warpgroup) or 0 (A rows)
    in_bytes: int    # bytes of one
    nslots: int      # ring slots for the streamed panels (0: none stream)
    slot_bytes: int
    wg_bytes: int
    const_bytes: int  # the epilogues' constants: bqkv, bf1 f32, bproj, bf2
    smem: int        # dynamic shared memory of the launch (0: no fit)


def const_stride(g: Geom) -> int:
    """``wbody::const_stride``: a block's epilogue constants (bqkv, bf1
    f32; bproj, bf2 bf16)."""
    return _round_up(4 * (g.nq + g.hp) + 2 * 2 * g.cp, 128)


# the train pair's factor rows of a warpgroup's tile: 64 x [attn, mlp] f32
FACTOR_BYTES = ROWS * 2 * 4


def persist_fit(g: Geom, blocks: int = 1) -> PersistFit:
    """``wbody::persist_fit``: the most resident GEMMs, then the input
    buffers, that leave at least two ring slots (up to MAX_SLOTS) for the
    streamed panels within an H100 block's shared memory. ``blocks`` 2 is
    the train-pair forward's plan: blocks a's and b's epilogue constants
    side by side, then each warpgroup's factor rows; one block's panels
    resident at a time."""
    wb = wg_bytes(g)
    inb = _round_up(2 * ROWS * g.c, 128)
    cb = blocks * const_stride(g) + (PERSIST_WGS * FACTOR_BYTES
                                     if blocks > 1 else 0)
    plist = panel_list(g)
    for res in range(4, -1, -1):
        mine = [b for i, _, b in plist if i < res]
        slot = max([b for i, _, b in plist if i >= res], default=0)
        for nin in (2, 0):
            base = (PERSIST_WGS * wb + sum(mine) + nin * inb + PERSIST_CTRL
                    + cb)
            slots = 0
            if res < 4:
                slots = min((SMEM_OPTIN - base) // slot, MAX_SLOTS)
                if slots < 2:
                    continue
            elif base > SMEM_OPTIN:
                continue
            return PersistFit(res, len(mine), sum(mine), nin, inb, slots,
                              slot, wb, cb, base + slots * slot)
    return PersistFit(0, 0, 0, 0, inb, 0, 0, wb, cb, 0)


def section_of(gemm: int) -> int:
    """``wbody::section_of``: qkv 0, proj 1, fc1 and fc2 2."""
    return min(gemm, 2)


def turn_order(g: Geom, res: int, pairs: int):
    """The ring's order of the persistent kernel's streamed panels
    (``wbody::produce_turns``) over ``pairs`` tile pairs of one thread
    block: (pair, warpgroup, panel index in the block) per ring position;
    and each warpgroup's own walk, as ``Turned::seq`` maps it, must land on
    the same positions."""
    plist = panel_list(g)
    out = []
    for pair in range(pairs):
        for s in range(3):
            for w in range(PERSIST_WGS):
                out += [(pair, w, k) for k, (i, _, _) in enumerate(plist)
                        if i >= res and section_of(i) == s]
    return out


def turned_seq(g: Geom, res: int, pair_it: int, wg: int, idx: int) -> int:
    """``wbody::Turned::seq``: the ring position of streamed panel ``idx``
    of warpgroup ``wg``'s tile in its ``pair_it``-th tile pair."""
    plist = panel_list(g)
    nres = sum(1 for i, _, _ in plist if i < res)
    k = [sum(1 for i, _, _ in plist if i >= res and section_of(i) == s)
         for s in range(3)]
    before = [0, k[0], k[0] + k[1]]
    total = sum(k)
    u = idx - nres
    s = 0 if u < before[1] else (1 if u < before[2] else 2)
    return pair_it * 2 * total + 2 * before[s] + wg * k[s] + (u - before[s])


def conv_smem_bytes(c0: int, ccat: int) -> int:
    """The conv kernel's shared memory: the (8+2) x (16+2) halo of ccatp
    channels and two slots of one tap's weights."""
    ccatp = _round_up(ccat, 16)
    slot = _round_up(panel_bytes(_round_up(c0, 32), ccatp), 128)
    halo = _round_up((CONV_ROWS + 2) * (CONV_COLS + 2) * ccatp * 2, 128)
    return halo + CONV_SLOTS * slot + CTRL_BYTES


def panels(w, n_pad: int):
    """One GEMM's (out, in) weight -> its panels, flat: rows zero-padded
    to n_pad, then per N-piece of 64, per K-piece of 256, in core-matrix
    order (8 rows x 8 inputs contiguous)."""
    n, k = w.shape
    wp = w.new_zeros(n_pad, k)
    wp[:n] = w
    out = []
    for n0 in range(0, n_pad, PANEL_N):
        for k0 in range(0, k, PANEL_K):
            piece = wp[n0:n0 + PANEL_N, k0:k0 + PANEL_K]
            nn, kk = piece.shape
            out.append(piece.reshape(nn // 8, 8, kk // 8, 8)
                       .permute(0, 2, 1, 3).reshape(-1))
    return torch.cat(out)


def unpanel(flat, n: int, n_pad: int, k: int):
    """The inverse of :func:`panels`: the first n rows of the (n_pad, k)
    weight."""
    w = flat.new_empty(n_pad, k)
    off = 0
    for n0 in range(0, n_pad, PANEL_N):
        for k0 in range(0, k, PANEL_K):
            nn, kk = min(PANEL_N, n_pad - n0), min(PANEL_K, k - k0)
            w[n0:n0 + nn, k0:k0 + kk] = flat[off:off + nn * kk].reshape(
                nn // 8, kk // 8, 8, 8).permute(0, 2, 1, 3).reshape(nn, kk)
            off += nn * kk
    if off != flat.numel():
        raise ValueError(f"{flat.numel()} panel elements for ({n_pad}, {k})")
    return w[:n]


def _head_index(c: int, nh: int, cp: int):
    """(kernel_layout index, head-padded index) of each qkv output channel
    (part, head, d): part * cp + h * hd + d and part * s + h * hdq + d."""
    hd = c // nh
    hdq = _round_up(hd, 8)
    part, h, d = torch.meshgrid(torch.arange(3), torch.arange(nh),
                                torch.arange(hd), indexing="ij")
    return ((part * cp + h * hd + d).reshape(-1),
            (part * nh * hdq + h * hdq + d).reshape(-1))


def stage_layout(layout, c: int, nh: int, adapter=None):
    """The window body's operands of one block (width c, nh heads) from
    ``kernel_layout``'s (wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2):
    (panels, bqkv, bproj, bf1, bf2). The qkv weight and bias take each
    head's channels head-padded (output row part * s + h * hdq + d, zero
    rows and bias between; the bias (nq,) f32), the proj weight reads the
    attention output head-padded (input column h * hdq + d, sq wide);
    the panels of qkv, proj, fc1 and fc2 follow each other in one bf16
    buffer, then those of ``adapter``, an (out, in) (growth, cp) weight,
    when given; bproj, bf1, bf2 as they are."""
    wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2 = layout
    cp, hp = wproj.shape[0], w1.shape[0]
    g = make_geom(64, c, nh, 1)
    src, dst = _head_index(c, nh, cp)
    src, dst = src.to(wqkv.device), dst.to(wqkv.device)
    wq = wqkv.new_zeros(g.nq, cp)
    wq[dst] = wqkv[src]
    bq = bqkv.new_zeros(g.nq)
    bq[dst] = bqkv[src]
    third = src.numel() // 3
    wp = wproj.new_zeros(cp, g.sq)
    wp[:, dst[:third]] = wproj[:, src[:third]]
    parts = [panels(wq, g.nq), panels(wp, _round_up(cp, 32)),
             panels(w1, _round_up(hp, 32)), panels(w2, _round_up(cp, 32))]
    if adapter is not None:
        parts.append(panels(adapter, _round_up(adapter.shape[0], 32)))
    return (torch.cat(parts).contiguous(), bq, bproj, bf1, bf2)


def unpack_stage_layout(stage, c: int, nh: int, cp: int, hp: int,
                        growth: int = 0):
    """``kernel_layout``'s (wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2)
    from :func:`stage_layout`'s operands (and the adapter's (growth, cp)
    weight when growth > 0)."""
    flat, bq, bproj, bf1, bf2 = stage
    g = make_geom(64, c, nh, 1)
    shapes = [(g.nq, g.nq, cp), (cp, _round_up(cp, 32), g.sq),
              (hp, _round_up(hp, 32), cp), (cp, _round_up(cp, 32), hp)]
    if growth:
        shapes.append((growth, _round_up(growth, 32), cp))
    ws, off = [], 0
    for n, n_pad, k in shapes:
        size = n_pad * k
        ws.append(unpanel(flat[off:off + size], n, n_pad, k))
        off += size
    if off != flat.numel():
        raise ValueError(f"{flat.numel()} panel elements, {off} expected")
    src, dst = _head_index(c, nh, cp)
    src, dst = src.to(flat.device), dst.to(flat.device)
    wqkv = ws[0].new_zeros(3 * cp, cp)
    wqkv[src] = ws[0][dst]
    bqkv = bq.new_zeros(3 * cp)
    bqkv[src] = bq[dst]
    third = src.numel() // 3
    wproj = ws[1].new_zeros(cp, cp)
    wproj[:, src[:third]] = ws[1][:, dst[:third]]
    out = (wqkv, bqkv, wproj, bproj, ws[2], bf1, ws[3], bf2)
    return out + (ws[4],) if growth else out


def stage_bias(bias, nh: int):
    """The packed (bw, N, nH*N) bf16 attention bias in the order the
    window body's attention reads it: per window, head and 16-row block,
    per lane 4 g + t of the warp, its key tiles j, each as the pair of
    rows (16 mt + g, 16 mt + g + 8) of keys (8 j + 2 t, 8 j + 2 t + 1);
    flat bf16."""
    bw, n, _ = bias.shape
    b = bias.reshape(bw, n // 16, 2, 8, nh, n // 8, 4, 2)
    return b.permute(0, 4, 1, 3, 6, 5, 2, 7).contiguous().reshape(-1)


def unpack_stage_bias(flat, nh: int, n: int):
    """The inverse of :func:`stage_bias`."""
    bw = flat.numel() // (n * nh * n)
    b = flat.reshape(bw, nh, n // 16, 8, 4, n // 8, 2, 2)
    return b.permute(0, 2, 6, 3, 1, 5, 4, 7).reshape(bw, n, nh * n)


def conv_panels(wc, c0: int, ccat: int):
    """The conv's tap-major (9*C_cat, C0) bf16 rows -> its panels: per
    N-piece of 64 output channels, per tap, per K-piece of 256 inputs,
    each tap's (out, in) = (C0 to 32, C_cat to 16) weight in core-matrix
    order."""
    no, ccatp = _round_up(c0, 32), _round_up(ccat, 16)
    taps = wc.reshape(9, ccat, c0).permute(0, 2, 1)  # (tap, out, in)
    full = wc.new_zeros(9, no, ccatp)
    full[:, :c0, :ccat] = taps
    out = []
    for n0 in range(0, no, PANEL_N):
        for t in range(9):
            for k0 in range(0, ccatp, PANEL_K):
                piece = full[t, n0:n0 + PANEL_N, k0:k0 + PANEL_K]
                nn, kk = piece.shape
                out.append(piece.reshape(nn // 8, 8, kk // 8, 8)
                           .permute(0, 2, 1, 3).reshape(-1))
    return torch.cat(out).contiguous()


def unpack_conv_panels(flat, c0: int, ccat: int):
    """The inverse of :func:`conv_panels`: the tap-major (9*C_cat, C0)
    rows."""
    no, ccatp = _round_up(c0, 32), _round_up(ccat, 16)
    full = flat.new_empty(9, no, ccatp)
    off = 0
    for n0 in range(0, no, PANEL_N):
        for t in range(9):
            for k0 in range(0, ccatp, PANEL_K):
                nn, kk = min(PANEL_N, no - n0), min(PANEL_K, ccatp - k0)
                full[t, n0:n0 + nn, k0:k0 + kk] = flat[
                    off:off + nn * kk].reshape(nn // 8, kk // 8, 8, 8
                                               ).permute(0, 2, 1, 3
                                                         ).reshape(nn, kk)
                off += nn * kk
    return full[:, :c0, :ccat].permute(0, 2, 1).reshape(9 * ccat, c0)


def window_pixels(h: int, w: int, ws: int, shift: int):
    """(nW, N) flat pixel index of each row of each window of an h x w
    image rolled by (-shift, -shift): row r of window wi is the pixel
    ((wy ws + r // ws + s) mod h, (wx ws + r % ws + s) mod w), the
    kernels' gather and scatter (``pixel`` in the CUDA sources)."""
    nww = w // ws
    wi = torch.arange((h // ws) * nww)[:, None]
    r = torch.arange(ws * ws)[None, :]
    yy = ((wi // nww) * ws + r // ws + shift) % h
    xx = ((wi % nww) * ws + r % ws + shift) % w
    return yy * w + xx
