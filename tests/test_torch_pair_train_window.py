"""The train-pair forward on the window body (``csrc/pair_train.cu``):
what of it the CPU can check.

* The plain version (``pair_train_reference``) and its autograd gradient
  against the JAX kernel in interpret mode at RDST-W96's pair width (C =
  96, 6 heads, hidden 192, 2 images of 24x24, shift 4), 'clamp' and
  'stable', with and without stochastic-depth factor columns; bars as
  ``test_torch_pair_train.py`` (output 1e-2, gradients 2e-2, relative to
  the reference's max).
* The chained walk (``chained_walk``) at the training geometries, for
  every grid of 1-132 thread blocks: every tile done once, every block-b
  tile waiting only on block-a tiles of earlier pairs, and a simulation of
  the walk that ends (no deadlock).
* The moves between a tile's rows and y (``run_vectors``, the kernel's
  ``for_run_vectors``): block a's write and block b's rolled gather
  against ``swin_pair.shift_relayout`` on CPU tensors.
* The plan (``persist_fit(g, 2)``) against the source's constants, and
  its residency against the serving kernel's.
* The one-gather weight layout (``forward_layout``) against
  ``stage_layout(kernel_layout(p))`` and ``stage_bias``, bitwise.
* The wrapper's admission: every shipped config's train pair admitted,
  what the card cannot take refused before any launch.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import pair_train as pt
from rdst_tpu_torch.kernels import window_body as wb
from rdst_tpu_torch.kernels.swin_block import (fast_params, kernel_layout,
                                               pack_bias_fast)
from rdst_tpu_torch.kernels.swin_pair import shift_relayout
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import set_train_mode

from test_torch_pair_train import _case, _compare, _jax_side, _params, \
    _torch_side

_CSRC = Path(pt.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("softmax", ["clamp", "stable"])
@pytest.mark.parametrize("with_dpf", [False, True])
def test_plain_matches_jax_kernel_at_w96_width(monkeypatch, softmax,
                                               with_dpf):
    cs = _case(3, 96, 6, 8, 24, 24, 2, 4, with_dpf)
    _compare(_torch_side(cs, softmax),
             _jax_side(cs, softmax, monkeypatch, kernel=True))


def _tiles(windows: int, n: int) -> int:
    return -(-windows * n // wb.ROWS)


def _windows_of(tile: int, windows: int, n: int):
    per = wb.ROWS // n
    return range(tile * per, min((tile + 1) * per, windows))


# (images, windows an image, tokens a window): E1 / W96 training (32
# images of 24x24 at window 8), 4 images of 16x16 at window 4, and an odd
# tile count (a block's last pair with an empty second tile)
WALKS = [(32, 9, 64), (4, 16, 16), (3, 9, 64)]


@pytest.mark.parametrize("images,nw,n", WALKS)
def test_chained_walk_waits_only_on_earlier_tiles(images, nw, n):
    windows = images * nw
    tiles = _tiles(windows, n)
    pairs_a = -(-tiles // 2)
    for grid in range(1, 133):
        walk = pt.chained_walk(pairs_a, min(grid, 2 * pairs_a))
        done = {}
        for blk_walk in walk:
            for blk, pair in blk_walk:
                for wg in (0, 1):
                    tile = 2 * pair + wg
                    if tile < tiles:
                        key = (blk, tile)
                        assert key not in done
                        done[key] = True
        assert sorted(done) == [(b, t) for b in (0, 1) for t in range(tiles)]

        def pair_index(blk, pair):
            return pair + blk * pairs_a

        def needs(pair):  # block-a pairs a block-b pair waits on
            out = set()
            for wg in (0, 1):
                for gw in _windows_of(2 * pair + wg, windows, n):
                    img = gw // nw
                    for wa in range(img * nw, (img + 1) * nw):
                        out.add((wa * n // wb.ROWS) // 2)
            return out

        for blk_walk in walk:
            for blk, pair in blk_walk:
                if blk == 1:
                    assert all(pair_index(0, q) < pair_index(1, pair)
                               for q in needs(pair))
        # every thread block runs its walk in order; a block-b pair starts
        # once the block-a pairs it needs are done
        pos, finished = [0] * len(walk), set()
        while True:
            moved = False
            for b, blk_walk in enumerate(walk):
                if pos[b] == len(blk_walk):
                    continue
                blk, pair = blk_walk[pos[b]]
                if blk == 0 or needs(pair) <= finished:
                    if blk == 0:
                        finished.add(pair)
                    pos[b] += 1
                    moved = True
            if not moved:
                break
        assert pos == [len(w) for w in walk], grid


def _to_y(rows_bytes, y_bytes, moves, v):
    for gy, gt in moves:
        y_bytes[gy:gy + v] = rows_bytes[gt:gt + v]


def _from_y(y_bytes, rows_bytes, moves, v):
    for gy, gt in moves:
        rows_bytes[gt:gt + v] = y_bytes[gy:gy + v]


# (images, H, W, window, C, shift): E1's and W96's training pairs, 16-token
# windows, one window an image, odd C (a pixel row of 90 bytes)
ROLLS = [(2, 24, 24, 8, 60, 4), (2, 24, 24, 8, 90, 4), (1, 24, 24, 8, 96, 4),
         (1, 24, 24, 8, 120, 4), (3, 16, 16, 4, 12, 2), (5, 8, 8, 8, 30, 0),
         (2, 8, 8, 4, 45, 2)]


@pytest.mark.parametrize("images,h,w,ws,c,shift", ROLLS)
def test_rolled_gather_matches_shift_relayout(images, h, w, ws, c, shift):
    """Block a's tiles written to y and block b's gathered back, byte by
    byte as the kernel's vectors move them, give shift_relayout of block
    a's output; no vector crosses the image's edge."""
    n, nw = ws * ws, (h // ws) * (w // ws)
    windows = images * nw
    rng = np.random.default_rng(images * 1000 + c)
    ya = torch.from_numpy(rng.normal(0, 1, (windows, n, c)).astype(
        np.float32)).to(torch.bfloat16)
    flat = ya.view(torch.int16).numpy().view(np.uint8).reshape(-1)
    y = np.zeros(images * h * w * c * 2, np.uint8)
    tile_bytes = wb.ROWS * 2 * c
    per = wb.ROWS // n
    for tile in range(_tiles(windows, n)):
        gw0 = tile * per
        rows = min(per, windows - gw0) * n
        v, moves = pt.run_vectors((h, w), ws, c, 0, gw0, rows)
        assert len({m[1] for m in moves}) * v == rows * 2 * c
        _to_y(flat[tile * tile_bytes:], y, moves, v)
    got = np.zeros_like(flat)
    for tile in range(_tiles(windows, n)):
        gw0 = tile * per
        rows = min(per, windows - gw0) * n
        v, moves = pt.run_vectors((h, w), ws, c, shift, gw0, rows)
        for gy, _ in moves:  # within one image row of y
            row = gy // (w * 2 * c)
            assert (gy + v - 1) // (w * 2 * c) == row
        part = np.zeros(rows * 2 * c, np.uint8)
        _from_y(y, part, moves, v)
        got[tile * tile_bytes:tile * tile_bytes + rows * 2 * c] = part
    want = shift_relayout(ya, (h, w), ws, shift)
    got_t = torch.from_numpy(got.view(np.int16).copy()).view(
        torch.bfloat16).reshape(windows, n, c)
    assert torch.equal(got_t.view(torch.int16), want.view(torch.int16))


def _constexpr(source, name):
    text = (_CSRC / source).read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def test_forward_plan_mirrors_the_source():
    assert _constexpr("window_body.cuh", "kFactorBytes") == "kRows * 2 * 4"
    assert wb.FACTOR_BYTES == wb.ROWS * 2 * 4 == 512
    body = (_CSRC / "window_body.cuh").read_text()
    assert ("return round_up(4 * (g.nq + g.hp) + 2 * 2 * g.cp, 128);"
            in body)
    assert ("f.const_bytes = blocks * const_stride(g) +\n"
            "                  (blocks > 1 ? kPersistWgs * kFactorBytes : 0);"
            in body)
    src = (_CSRC / "pair_train.cu").read_text()
    # the swap barrier after the resident panels' and the two input bars,
    # within the control bytes the plan keeps
    assert "swap_bar = res_bar + 8 * (1 + wbody::kPersistWgs)" in src
    assert wb.CTRL_BYTES + 8 * (1 + wb.PERSIST_WGS) + 8 <= wb.PERSIST_CTRL
    assert "a.f = wbody::persist_fit(a.g, 2);" in src


@pytest.mark.parametrize("n", [64, 16])
@pytest.mark.parametrize("c", [60, 90, 96, 120])
def test_forward_plan_keeps_the_serving_residency(n, c):
    """Both blocks' constants and the factor rows cost no resident GEMM
    or input buffer against the serving kernel's plan: every panel
    resident at C = 60, qkv + proj at C = 90 / 96, none at C = 120."""
    g = wb.make_geom(n, c, 6, 2 * c)
    one, two = wb.persist_fit(g), pt.forward_plan(n, c, 6, 2 * c)
    assert (two.res, two.nin, two.nslots) == (one.res, one.nin, one.nslots)
    assert two.res == {60: 4, 90: 2, 96: 2, 120: 0}[c]
    assert two.const_bytes == 2 * wb.const_stride(g) + 2 * wb.FACTOR_BYTES
    assert two.smem == one.smem + wb.const_stride(g) + 2 * wb.FACTOR_BYTES
    assert two.smem <= wb.SMEM_OPTIN
    assert pt.forward_turns(n, c, 6, 2 * c) == (c > 60)


def _blocks(rng, c, nh, n, nw, shifted):
    pa = fast_params([torch.from_numpy(a) for a in _params(rng, c, 2 * c)],
                     c, nh)
    pb = fast_params([torch.from_numpy(a) for a in _params(rng, c, 2 * c)],
                     c, nh)
    ba = pack_bias_fast(torch.from_numpy(
        rng.normal(0, 1, (nh, n, n)).astype(np.float32)), nh, n)
    bb = pack_bias_fast(torch.from_numpy(rng.normal(
        0, 1, ((nh * nw if shifted else nh), n, n)).astype(np.float32)),
        nh, n)
    return pa, ba, pb, bb


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("c,nh,ws,nw,shifted", [
    (60, 6, 8, 9, True), (90, 6, 8, 9, True), (96, 6, 8, 9, True),
    (120, 6, 8, 1, False), (12, 2, 4, 16, True)])
def test_forward_layout_is_one_gather_bitwise(c, nh, ws, nw, shifted):
    rng = np.random.default_rng(c)
    n = ws * ws
    pa, ba, pb, bb = _blocks(rng, c, nh, n, nw, shifted)
    ops_a, ops_b = pt.forward_layout(pa, ba, pb, bb, nh)
    for ops, p, bias in ((ops_a, pa, ba), (ops_b, pb, bb)):
        want = [*wb.stage_layout(kernel_layout(p), c, nh),
                wb.stage_bias(bias, nh)]
        assert len(ops) == len(want) == 6
        for got, ref in zip(ops, want):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert torch.equal(_bits(got), _bits(ref))
            # 128-byte aligned on the card's 256-byte aligned allocations
            assert (got.data_ptr() - ops_a[0].data_ptr()) % 128 == 0
    # the index is made once per geometry
    index = pt.layout_index(n, c, nh, 2 * c, (ba.shape[0], bb.shape[0]),
                            ba.device)
    assert pt.layout_index(n, c, nh, 2 * c, (ba.shape[0], bb.shape[0]),
                           ba.device) is index


def _model(config, **kw):
    p = ParametersLoader(config)
    for k, v in kw.items():
        p.set(k, v)
    return build_generator(p, dtype=torch.bfloat16)


@pytest.mark.parametrize("config,routes", [
    ("config_files/rdst_e1_100k_oasis20_x4.ini", {"pair": 24, "block": 0}),
    ("config_files/rdst_w96_100k_oasis20_x4.ini", {"pair": 8, "block": 32}),
])
def test_shipped_train_pairs_admitted(config, routes):
    """E1's pairs (C = 60 / 90 / 120) and W96's (C = 96; its C = 144 and
    192 DSTLs train block by block) take the train-pair kernels."""
    model = _model(config)
    assert set_train_mode(model, "pair") == "pair"
    assert model.train_routes == routes


def test_swinir_light_block_geometry_admitted():
    """SwinIR-light's blocks (C = 60, 6 heads, window 8, hidden 120) are a
    geometry the train pair takes."""
    p = ParametersLoader("config_files/swinir_light_40k_oasis20_x4.ini")
    c, ws, nh = p.sir_embed_dim, p.sir_window_size, set(p.sir_num_heads)
    assert (c, ws, nh) == (60, 8, {6})
    hidden = int(c * p.sir_hidden_ratio)
    assert hidden == 120
    assert pt.pair_train_kernel_supports(ws * ws, c, 6, hidden)


@pytest.mark.parametrize("c,nh,hidden", [(128, 4, 512), (30, 30, 60)])
def test_wrapper_refuses_what_the_plan_cannot_fit(c, nh, hidden):
    """Geometries the window body takes but whose two-block plan does not
    fit an H100 block (the MLP's hidden rows at 512; 30 heads of 1
    channel, each padded to 8) raise before any launch, on the CPU as on
    the card."""
    assert wb.body_supports(64, c, nh, hidden)
    assert not pt.pair_train_kernel_supports(64, c, nh, hidden)
    rng = np.random.default_rng(0)
    fp = fast_params([torch.from_numpy(a) for a in _params(rng, c, hidden)],
                     c, nh)
    bias = torch.zeros(1, 64, nh * 64, dtype=torch.bfloat16)
    before = pt.launch_forward.launches
    with pytest.raises(ValueError, match="pallas_train='off'"):
        pt.run_pair_train(torch.zeros(9, 64, c, dtype=torch.bfloat16), fp,
                          bias, fp, bias.expand(9, -1, -1), num_heads=nh,
                          x_size=(24, 24), window_size=8, shift=4)
    assert pt.launch_forward.launches == before
