"""The bf16 fast branch of the fused Swin block:
``rdst_tpu_torch.kernels.swin_block`` (``fused_swin_block`` on bf16
tokens, its plain version ``swin_block_fast_reference`` and the weight
folds) against ``rdst_tpu.kernels.swin_block.fused_swin_block`` in
interpret mode, as ``tests/test_kernels.py`` runs it.

Inputs come from a numpy seed and go to both packages. The bar is the
relative error ``max|port - jax| / max|jax|``:

* plain version vs JAX kernel: <= 0.01. Both round to bf16 at the same
  places; what differs is f32 summation order (a bf16 rounding may land
  on the other side) and the JAX approximate reciprocal, which the plain
  version replaces by an exact division. Measured here: <= 0.005.
* the folded weights: bitwise equal after the bf16 casts; the f32 folded
  biases within 1e-6 relative (summation order of ``b @ W``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu.nn.swin import (relative_position_index as jax_rel_index,
                              shift_attention_mask as jax_mask)
from rdst_tpu_torch.kernels import swin_block as sb

TOL = 0.01
WS, N = 8, 64
H, W = 16, 24  # 6 windows per image
NW = (H // WS) * (W // WS)
VARIANTS = ["stable", "clamp", "stable_bc", "stable_mm"]


def block_inputs(c, nh, shifted, images=2, seed=0, qkv_scale=1.0):
    """Seeded x, the 12-param bundle (JAX layout) and the head-major bias
    (rel-pos, + the shift mask per window when shifted)."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.2):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    table = f((2 * WS - 1) ** 2, nh, scale=1.0)
    rel = table[jax_rel_index(WS, WS).reshape(-1)].reshape(N, N, nh)
    rel = rel.transpose(2, 0, 1)
    if shifted:
        bias = (rel[:, None] + jax_mask(H, W, WS, WS // 2)[None]
                ).reshape(nh * NW, N, N)
    else:
        bias = rel
    hid = 2 * c
    wc, wh = c ** -0.5, hid ** -0.5
    params = [f(c, 3 * c, scale=wc * qkv_scale), f(3 * c), f(c, c, scale=wc),
              f(c), 1.0 + f(c), f(c), 1.0 + f(c), f(c),
              f(c, hid, scale=wc), f(hid), f(hid, c, scale=wh), f(c)]
    x = f(images * NW, N, c, scale=1.0)
    return x, params, np.ascontiguousarray(bias)


def jax_fast_block(monkeypatch, x, params, bias, nh, softmax):
    """JAX ``fused_swin_block`` on bf16 (its fast branch) in interpret
    mode, with the weights cast as ``nn/swin.py`` casts them."""
    if softmax in ("", "stable"):
        monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    bf = jnp.bfloat16
    jp = [jnp.asarray(p).astype(bf) for p in params]
    for i in (4, 5, 6, 7):  # LN affines stay f32
        jp[i] = jnp.asarray(params[i])
    out = jax_sb.fused_swin_block(
        jnp.asarray(x).astype(bf), *jp, jnp.asarray(bias).astype(bf),
        num_heads=nh, windows_per_image=NW, interpret=True)
    clear_kernel_caches()
    return np.asarray(out.astype(jnp.float32))


def port_fast_block(x, params, bias, nh, softmax):
    t = [torch.from_numpy(p) for p in params]
    return sb.fused_swin_block(
        torch.from_numpy(x).bfloat16(), *t, torch.from_numpy(bias).bfloat16(),
        num_heads=nh, windows_per_image=NW, softmax=softmax).float().numpy()


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("softmax", VARIANTS)
@pytest.mark.parametrize("shifted", [False, True], ids=["shared", "shifted"])
@pytest.mark.parametrize("c,nh", [(12, 3), (60, 6)], ids=["c12", "c60"])
def test_reference_matches_jax_fast_block(monkeypatch, c, nh, shifted,
                                          softmax):
    x, params, bias = block_inputs(c, nh, shifted)
    want = jax_fast_block(monkeypatch, x, params, bias, nh, softmax)
    got = port_fast_block(x, params, bias, nh, softmax)
    assert got.shape == want.shape == x.shape
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("softmax", ["stable", "stable_bc"])
@pytest.mark.parametrize("shift", [0, 4])
def test_large_logit_stable_variants_match_jax(monkeypatch, shift, softmax):
    """``test_kernels.py``'s large-logit case: the qkv weights x 80 put
    the logits near 4e4; the exact stable variants must still track the
    JAX kernel. ('stable_mm' rounds the row max to bf16, a step of 256 at
    that size, so exp(s - max) overflows in the JAX kernel as in the
    port; ``test_kernels.py`` does not hold it to this case either.)"""
    x, params, bias = block_inputs(12, 3, shift > 0, seed=1, qkv_scale=80.0)
    want = jax_fast_block(monkeypatch, x, params, bias, 3, softmax)
    got = port_fast_block(x, params, bias, 3, softmax)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("shift", [0, 4])
def test_pack_mode_matches_jax_pack(rng, monkeypatch, shift):
    """The JAX 'pack' mode (pack=2: two windows per lane row, a TPU layout)
    against the port's block built in mode 'pack', which runs the fast
    block kernel: the same function."""
    import jax

    from rdst_tpu.nn.swin import SwinTransformerBlock as JaxBlock
    from rdst_tpu_torch.models.rdst import RDSTSR, set_kernel_mode
    from test_torch_nn import _load, _randomize, _swin_block_sd

    b, h, w, c, nh = 2, 16, 24, 12, 3
    xf = rng.normal(0, 1, (b, h * w, c)).astype(np.float32)
    blk = JaxBlock(dim=c, num_heads=nh, window_size=WS, shift_size=shift,
                   mlp_ratio=2.0, build_resolution=(h, w), dtype=jnp.bfloat16)
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    params = _randomize(blk.init(jax.random.PRNGKey(0), xf, (h, w)), 3)
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS", "pack")
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    x16 = jnp.asarray(xf).astype(jnp.bfloat16)
    want = np.asarray(blk.apply(params, x16, (h, w)), np.float32)

    from rdst_tpu_torch.nn import swin as ts

    mod = _load(ts.SwinTransformerBlock(c, nh, WS, shift, 2.0,
                                        build_resolution=(h, w)),
                _swin_block_sd(params))
    # route the block as a bf16 model in mode 'pack' routes it
    holder = RDSTSR(embed_dim=c, dense_layer_depths=(2,), num_heads=(nh,),
                    window_size=(WS,), rdb_depths=(1,), growth_rate=6,
                    build_resolution=(h, w), dtype=torch.bfloat16)
    holder.body[0].body[0].body.blocks[0] = mod
    assert set_kernel_mode(holder, "pack") == ["fused_swin_block"]
    assert mod.use_kernel
    before = sb.run_fast_block.launches
    with torch.inference_mode():
        got = mod(torch.from_numpy(np.array(x16.astype(jnp.float32)))
                  .bfloat16(), (h, w)).float().numpy()
    assert sb.run_fast_block.launches == before  # CPU: the plain version
    assert rel_err(got, want) <= TOL


def test_fold_matches_jax_on_flagship_weights():
    """``prep_block_params`` of every Swin block of the shipped flagship
    snapshot: bitwise equal to the JAX fold after the bf16 casts; the f32
    folded biases within 1e-6 relative."""
    import pathlib

    from rdst_tpu_torch.checkpoint import msgpack_reader as mr

    snap = pathlib.Path(__file__).resolve().parents[1] / "weights" / \
        "rdst_e1_40k_best_oasis20_x4.msgpack"
    tree = mr.read_snapshot(str(snap))["params"]
    checked = 0
    for i in range(8):
        for d in range(3):
            body = tree[f"body_{i}"][f"body_{d}"]["body"]
            for k in range(2):
                blk = body[f"blocks_{k}"]
                a = blk["attn"]
                params = [a["qkv"]["kernel"], a["qkv"]["bias"],
                          a["proj"]["kernel"], a["proj"]["bias"],
                          blk["norm1"]["scale"], blk["norm1"]["bias"],
                          blk["norm2"]["scale"], blk["norm2"]["bias"],
                          blk["mlp"]["fc1"]["kernel"], blk["mlp"]["fc1"]["bias"],
                          blk["mlp"]["fc2"]["kernel"], blk["mlp"]["fc2"]["bias"]]
                c = params[0].shape[0]
                want = jax_sb.prep_block_params(
                    [jnp.asarray(p) for p in params], c, 6, jnp.bfloat16)
                got = sb.prep_block_params(
                    [torch.from_numpy(np.array(p)) for p in params], c, 6)
                for j, (g, w_) in enumerate(zip(got, want)):
                    w_ = np.asarray(w_.astype(jnp.float32))
                    g = g.float().numpy()
                    assert g.shape == w_.shape, j
                    if j in (1, 9):  # folded f32 biases
                        assert np.abs(g - w_).max() <= 1e-6 * np.abs(w_).max()
                    else:
                        assert np.array_equal(g, w_), j
                checked += 1
    assert checked == 48


def test_pack_bias_matches_jax():
    bias = np.random.default_rng(2).normal(size=(6 * NW, N, N)).astype(
        np.float32)
    want = np.asarray(jax_sb.pack_bias_fast(jnp.asarray(bias), 6, N,
                                            jnp.bfloat16).astype(jnp.float32))
    got = sb.pack_bias_fast(torch.from_numpy(bias), 6, N).float().numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("v", ["", "stable", "stable_bc", "clamp",
                               "stable_mm", "auto", "exact"])
def test_softmax_codes(v):
    """The kernels know the resolved variants; 'auto' is resolved when the
    model is built and never reaches them."""
    if v in ("auto", "exact"):
        with pytest.raises(ValueError, match="softmax variant"):
            sb.softmax_code(v)
    else:
        assert sb.softmax_code(v) == {"clamp": 1, "stable_mm": 2}.get(v, 0)


@pytest.mark.parametrize("n,c,nh,hid,ok", [
    (64, 60, 6, 120, True), (64, 90, 6, 180, True), (64, 120, 6, 240, True),
    (16, 12, 3, 24, True),
    (49, 60, 6, 120, False),   # window 7: N not a multiple of 16
    (64, 180, 6, 360, False),  # SwinIR-std width: C > 128
    (64, 66, 2, 132, False),   # head dim 33 > 32
])
def test_fast_kernel_gate(n, c, nh, hid, ok):
    assert sb.fast_kernel_supports(n, c, nh, hid) is ok


def test_fast_wrapper_refuses_geometry_without_launch():
    """A geometry the fast kernel does not take raises before any device
    work, the same on the CPU as on the card; nothing launches."""
    g = torch.Generator().manual_seed(0)
    n, c, nh, hid = 49, 60, 6, 120

    def r(*shape):
        return torch.randn(*shape, generator=g)

    args = [r(2, n, c).bfloat16(), r(c, 3 * c), r(3 * c), r(c, c), r(c),
            r(c), r(c), r(c), r(c), r(c, hid), r(hid), r(hid, c), r(c),
            r(nh, n, n).bfloat16()]
    before = sb.run_fast_block.launches
    with pytest.raises(ValueError, match="does not take"):
        sb.fused_swin_block(*args, num_heads=nh, windows_per_image=2)
    assert sb.run_fast_block.launches == before


def test_smem_budget_flagship():
    """One window's fast block at the flagship widths fits in an H100
    block's shared memory (the attention region holds the MLP rows)."""
    for c in (60, 90, 120):
        assert sb.fast_smem_bytes(N, c, 6, 2 * c) <= sb.H100_SMEM_OPTIN
    # x f32, LN rows, q/k (6 heads x 24), v^T (6 x 24 rows) at C = 120:
    # two blocks of it fit on an SM (228 KB, 1 KB reserved per block)
    assert sb.fast_smem_bytes(N, 120, 6, 240) == (
        4 * 64 * 120 + 2 * 64 * 136 + 2 * (2 * 64 * 152 + 144 * 72))
    assert 2 * (sb.fast_smem_bytes(N, 120, 6, 240) + 1024) <= 233472


# ---------------------------------------------------------------------------
# The persistent window kernel (csrc/swin_block_fast.cu) at C <= 120: its
# plan (kernels.window_body.persist_fit, wbody::persist_fit), its turn
# order and its route
# ---------------------------------------------------------------------------

_CSRC = Path(sb.__file__).resolve().parents[1] / "csrc"


def _constexpr(name):
    text = (_CSRC / "window_body.cuh").read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def test_persist_plan_mirrors_the_source():
    from rdst_tpu_torch.kernels import window_body as wb

    assert int(_constexpr("kPersistWgs")) == wb.PERSIST_WGS == 2
    assert int(_constexpr("kMaxSlots")) == wb.MAX_SLOTS
    assert int(_constexpr("kSmemOptin")) == wb.SMEM_OPTIN == \
        sb.H100_SMEM_OPTIN
    assert int(_constexpr("kRows")) == wb.ROWS
    assert (int(_constexpr("kPanelN")), int(_constexpr("kPanelK"))) == (
        wb.PANEL_N, wb.PANEL_K)
    assert _constexpr("kCtrlBytes") == "16 * kMaxSlots"
    assert _constexpr("kPersistCtrl") == "kCtrlBytes + 32"
    assert wb.PERSIST_CTRL == 16 * wb.MAX_SLOTS + 32
    assert int(_constexpr("kTurnBar")) == 3  # after __syncthreads, wg_sync


# (C, resident GEMMs, input buffers): every weight resident at C = 60;
# qkv and proj at C = 90, the next tile into the A rows; at C = 120 every
# panel streams
PERSIST = [(60, 4, 2), (90, 2, 0), (120, 0, 0)]


@pytest.mark.parametrize("n", [64, 16])
@pytest.mark.parametrize("c,res,nin", PERSIST)
def test_persist_plan_budget(n, c, res, nin):
    from rdst_tpu_torch.kernels import window_body as wb

    g = wb.make_geom(n, c, 6, 2 * c)
    f = wb.persist_fit(g)
    assert (f.res, f.nin) == (res, nin)
    plist = wb.panel_list(g)
    mine = [b for i, _, b in plist if i < res]
    assert (f.res_panels, f.res_bytes) == (len(mine), sum(mine))
    assert f.slot_bytes == max([b for i, _, b in plist if i >= res],
                               default=0)
    assert f.nslots == (0 if res == 4 else 2)
    assert f.wg_bytes == wb.wg_bytes(g)
    assert f.in_bytes == -(-2 * 64 * c // 128) * 128
    assert f.const_bytes == -(-(4 * (g.nq + g.hp) + 4 * g.cp) // 128) * 128
    assert f.smem == (2 * f.wg_bytes + f.res_bytes + f.nin * f.in_bytes
                      + f.nslots * f.slot_bytes + wb.PERSIST_CTRL
                      + f.const_bytes)
    assert 0 < f.smem <= sb.H100_SMEM_OPTIN
    # the plan keeps the most it can: one more resident GEMM, or the input
    # buffers beside these, would not fit
    if res < 4:
        more = sum(b for i, _, b in plist if i <= res) + f.const_bytes
        assert 2 * f.wg_bytes + more + wb.PERSIST_CTRL + 2 * max(
            [b for i, _, b in plist if i > res] or [0]) > sb.H100_SMEM_OPTIN
    if nin == 0:
        assert f.smem + 2 * f.in_bytes > sb.H100_SMEM_OPTIN
    assert sb.window_kernel_supports(n, c, 6, 2 * c)


@pytest.mark.parametrize("c,res,nin", PERSIST)
def test_turn_order_is_each_warpgroups_walk(c, res, nin):
    """The producer's ring order (both warpgroups' copies, section by
    section, in turn order) and each warpgroup's own walk
    (``Turned::seq``) name the same ring positions, each once."""
    from rdst_tpu_torch.kernels import window_body as wb

    g = wb.make_geom(64, c, 6, 2 * c)
    order = wb.turn_order(g, res, 3)
    nres = sum(1 for i, _, _ in wb.panel_list(g) if i < res)
    total = len(wb.panel_list(g))
    assert len(order) == 3 * 2 * (total - nres)
    seen = set()
    for it in range(3):
        for w in range(2):
            for k in range(nres, total):
                q = wb.turned_seq(g, res, it, w, k)
                assert order[q] == (it, w, k)
                seen.add(q)
    assert seen == set(range(len(order)))


@pytest.mark.parametrize("c", [60, 90, 120])
def test_window_layout_unpacks_to_the_plain_layout(c):
    """The window kernel's weights (``stage_layout`` of ``kernel_layout``,
    the resident prefix its first bytes) give the plain layout back
    bitwise, and its bias in fragment order the packed bias."""
    from rdst_tpu_torch.kernels import window_body as wb

    _, params, bias = block_inputs(c, 6, True, seed=c)
    p = sb.fast_params([torch.from_numpy(a) for a in params], c, 6)
    layout = sb.kernel_layout(p)
    stage = wb.stage_layout(layout, c, 6)
    back = wb.unpack_stage_layout(stage, c, 6, layout[2].shape[0],
                                  layout[4].shape[0])
    for a, b in zip(back, layout):
        assert torch.equal(a, b)
    f = wb.persist_fit(wb.make_geom(N, c, 6, 2 * c))
    assert f.res_bytes <= 2 * stage[0].numel()
    packed = sb.pack_bias_fast(torch.from_numpy(bias).bfloat16(), 6, N)
    assert torch.equal(wb.unpack_stage_bias(wb.stage_bias(packed, 6), 6, N),
                       packed)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fast_route_table(int8):
    """The window kernel up to C = 120 with bf16 qkv; the token-parallel
    forward above it and for int8 qkv (the window body has no int8
    product), as the pair's and the RDSTB's stages route."""
    for c in (12, 60, 90, 96, 120, 128, 144, 180, 192):
        want = "window" if c <= sb.WINDOW_MAX_C and not int8 else "tokens"
        assert sb.fast_route(c, int8) == want == sb.stage_route(c, int8)


def test_window_route_refuses_what_the_card_would():
    x, params, bias = block_inputs(60, 6, False)
    tp = [torch.from_numpy(a) for a in params]
    tb = torch.from_numpy(bias).bfloat16()
    assert sb.plan_fast_block(tp, tb, num_heads=6).route == "window"
    plan = sb.plan_fast_block(tp, tb, num_heads=6, quant=frozenset({"qkv"}))
    assert plan.route == "tokens" and plan.qkv is not None
    with pytest.raises(ValueError, match="bf16 qkv only"):
        sb.plan_fast_block(tp, tb, num_heads=6, route="window",
                           quant=frozenset({"qkv"}))
    with pytest.raises(ValueError, match="bf16 qkv only"):
        sb.plan_fast_block(tp, tb, num_heads=6, route="stage",
                           quant=frozenset({"qkv"}))
    _, wide, wbias = block_inputs(180, 6, False)
    wide = [torch.from_numpy(a) for a in wide]
    wbias = torch.from_numpy(wbias).bfloat16()
    assert sb.plan_fast_block(wide, wbias, num_heads=6).route == "tokens"
    with pytest.raises(ValueError, match="window kernel does not take"):
        sb.plan_fast_block(wide, wbias, num_heads=6, route="window")
    assert not sb.window_kernel_supports(32, 60, 6, 120)  # not 16 or 64
    assert not sb.window_kernel_supports(64, 128, 8, 256)  # C > 120
    with pytest.raises(ValueError, match="without turns"):
        sb.window_kernel_without_turns(
            torch.from_numpy(x).bfloat16(), plan._replace(route="window"),
            num_heads=6)
