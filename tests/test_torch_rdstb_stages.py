"""The stage kernels of the RDSTB and the DSTL pair, held on the CPU
through their staged plain versions (``rdstb_staged_reference``,
``swin_pair_staged_reference``: stage by stage what the kernels compute,
over the kernels' scratch layouts, gathers and the conv's implicit GEMM):

* against the plain versions (``rdstb_reference``, ``swin_pair_reference``)
  and against ``rdst_tpu``'s ``fused_rdstb`` and ``fused_swin_pair`` in
  interpret mode (as ``tests/test_torch_rdstb.py`` runs them): <= 0.02
  relative max error, ``test_kernels.py``'s bar for these kernels. Both
  sides round to bf16 at the same places; the staged versions sum the
  conv tap by tap and the JAX kernels use an approximate reciprocal, so a
  bf16 rounding may land the other way. Cases: the flagship width with
  the committed first-RDSTB weights, a small width, post- and pre-norm
  adapters, shift 0 and 4, every softmax variant, 16-token windows;
* the window body's weight panels and the conv's tap panels: unpacking
  gives ``kernel_layout``'s arrays and the tap-major rows back bitwise;
* the kernels' gather rule (``window_pixels``) is the relayout;
* the stage kernels' shared memory (the Python mirror of
  ``wbody::stage_fit``, the token-parallel tiles and the conv's) fits an
  H100 block for every geometry the gate admits on a shipped RDST config,
  bf16 or int8 qkv; the gate's answer and each DSTL's stage design for
  each shipped config.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import rdstb_block as jax_rb
from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu.nn.swin import (relative_position_index as jax_rel_index,
                              shift_attention_mask as jax_mask)
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import rdstb_block as rb
from rdst_tpu_torch.kernels import swin_block as sb
from rdst_tpu_torch.kernels import swin_pair as sp
from rdst_tpu_torch.kernels import window_body as wb
from test_torch_rdstb import flagship_rdstb

TOL = 0.02
ROOT = pathlib.Path(__file__).resolve().parents[1]
RDST_CONFIGS = sorted(p.name for p in (ROOT / "config_files").glob("rdst_*.ini"))


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bias(rng, nh, h, w, ws, shifted):
    n = ws * ws
    table = rng.normal(0.0, 1.0, ((2 * ws - 1) ** 2, nh)).astype(np.float32)
    rel = table[jax_rel_index(ws, ws).reshape(-1)].reshape(n, n, nh)
    rel = rel.transpose(2, 0, 1)
    if not shifted:
        return np.ascontiguousarray(rel, np.float32)
    nw = (h // ws) * (w // ws)
    return np.ascontiguousarray(
        (rel[:, None] + jax_mask(h, w, ws, ws // 2)[None]).reshape(
            nh * nw, n, n), np.float32)


def _block_params(rng, c):
    def f(*shape, scale=0.2):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    hid = 2 * c
    return [f(c, 3 * c, scale=c ** -0.5), f(3 * c), f(c, c, scale=c ** -0.5),
            f(c), 1.0 + f(c), f(c), 1.0 + f(c), f(c),
            f(c, hid, scale=c ** -0.5), f(hid), f(hid, c, scale=hid ** -0.5),
            f(c)]


def random_rdstb(c0, growth, nb, nh, h, w, ws, shift, prenorm, seed):
    """Seeded RDSTB weights in the JAX ``fused_rdstb`` layout."""
    rng = np.random.default_rng(seed)
    dstls, c = [], c0
    for _ in range(nb):
        blocks = [(_block_params(rng, c), _bias(rng, nh, h, w, ws, s))
                  for s in (False, shift > 0)]
        ca = c if prenorm else growth
        dstls.append({"blocks": blocks, "adapter": (
            rng.normal(0, c ** -0.5, (c, growth)).astype(np.float32),
            rng.normal(0, 0.2, growth).astype(np.float32),
            (1.0 + rng.normal(0, 0.2, ca)).astype(np.float32),
            rng.normal(0, 0.2, ca).astype(np.float32))})
        c += growth
    conv = rng.normal(0, (9 * c) ** -0.5, (3, 3, c, c0)).astype(np.float32)
    return dstls, conv, rng.normal(0, 0.2, c0).astype(np.float32)


def _torch_dstls(dstls):
    t = torch.from_numpy
    return [{"blocks": [([t(p) for p in params], t(bias).bfloat16())
                        for params, bias in d["blocks"]],
             "adapter": tuple(t(a) for a in d["adapter"])} for d in dstls]


def port_rdstb(x, dstls, ck, cb, *, nh, hw, ws, shift, growth, prenorm,
               softmax):
    """(staged, plain) versions of the port on the same plan."""
    plan = rb.plan_rdstb(_torch_dstls(dstls), torch.from_numpy(ck),
                         torch.from_numpy(cb), num_heads=nh, growth=growth,
                         adapter_prenorm=prenorm)
    xb = torch.from_numpy(x).bfloat16()
    kw = dict(num_heads=nh, x_size=hw, window_size=ws, shift=shift,
              growth=growth, adapter_prenorm=prenorm, softmax=softmax)
    staged = rb.rdstb_staged_reference(xb, plan.dstls, plan.wc, plan.bc,
                                       **kw)
    plain = rb.rdstb_reference(xb, plan.dstls, plan.wc, plan.bc, **kw)
    return staged.float().numpy(), plain.float().numpy()


def jax_rdstb(monkeypatch, x, dstls, ck, cb, *, nh, hw, ws, shift, growth,
              prenorm, softmax):
    if softmax == "stable":
        monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    bf = jnp.bfloat16
    jd = [{"blocks": [([jnp.asarray(p) for p in params],
                       jnp.asarray(bias).astype(bf))
                      for params, bias in d["blocks"]],
           "adapter": tuple(jnp.asarray(a) for a in d["adapter"])}
          for d in dstls]
    out = np.asarray(jax_rb.fused_rdstb(
        jnp.asarray(x).astype(bf), jd, jnp.asarray(ck), jnp.asarray(cb),
        num_heads=nh, x_size=hw, window_size=ws, shift=shift, growth=growth,
        adapter_prenorm=prenorm, interpret=True,
        quant=frozenset()).astype(jnp.float32))
    clear_kernel_caches()
    return out


# (c0, growth, nb, nh, (h, w), ws, shift, prenorm, softmax)
SMALL = {
    "postnorm_shift4_stable": (12, 6, 3, 3, (16, 24), 8, 4, False, "stable"),
    "prenorm_shift4_clamp": (12, 6, 3, 3, (16, 24), 8, 4, True, "clamp"),
    "postnorm_shift0_stable_mm": (12, 6, 2, 3, (16, 24), 8, 0, False,
                                  "stable_mm"),
    "prenorm_shift0_stable_bc": (12, 6, 2, 3, (16, 16), 8, 0, True,
                                 "stable_bc"),
    "window4_postnorm_shift2": (12, 6, 2, 3, (12, 16), 4, 2, False,
                                "stable"),
    "window4_prenorm_shift0_clamp": (12, 6, 2, 3, (12, 16), 4, 0, True,
                                     "clamp"),
}


@pytest.mark.parametrize("case", list(SMALL))
def test_rdstb_staged_matches_plain(case):
    c0, g, nb, nh, hw, ws, shift, prenorm, softmax = SMALL[case]
    assert rb.rdstb_kernel_supports(ws * ws, c0, g, nb, nh, 2.0)
    dstls, ck, cb = random_rdstb(c0, g, nb, nh, *hw, ws, shift, prenorm,
                                 seed=21)
    x = np.random.default_rng(22).normal(0, 0.5, (2, hw[0] * hw[1], c0)
                                         ).astype(np.float32)
    staged, plain = port_rdstb(x, dstls, ck, cb, nh=nh, hw=hw, ws=ws,
                               shift=shift, growth=g, prenorm=prenorm,
                               softmax=softmax)
    assert np.isfinite(staged).all()
    assert rel_err(staged, plain) <= TOL


@pytest.mark.parametrize("case", ["postnorm_shift4_stable",
                                  "prenorm_shift4_clamp",
                                  "window4_postnorm_shift2"])
def test_rdstb_staged_matches_jax(monkeypatch, case):
    c0, g, nb, nh, hw, ws, shift, prenorm, softmax = SMALL[case]
    dstls, ck, cb = random_rdstb(c0, g, nb, nh, *hw, ws, shift, prenorm,
                                 seed=23)
    x = np.random.default_rng(24).normal(0, 0.5, (2, hw[0] * hw[1], c0)
                                         ).astype(np.float32)
    kw = dict(nh=nh, hw=hw, ws=ws, shift=shift, growth=g, prenorm=prenorm,
              softmax=softmax)
    want = jax_rdstb(monkeypatch, x, dstls, ck, cb, **kw)
    staged, _ = port_rdstb(x, dstls, ck, cb, **kw)
    assert rel_err(staged, want) <= TOL


def test_flagship_rdstb_staged_matches_plain_and_jax(monkeypatch):
    """The committed first RDSTB of the flagship (C0 = 60, growth 30,
    widths 60/90/120, 6 heads, pre-norm adapters) on one 40x32 image, in
    its resolved softmax variant."""
    h, w = 40, 32
    dstls, ck, cb = flagship_rdstb(h, w)
    x = np.random.default_rng(25).normal(0, 1.0, (1, h * w, 60)).astype(
        np.float32)
    kw = dict(nh=6, hw=(h, w), ws=8, shift=4, growth=30, prenorm=True,
              softmax="clamp")
    staged, plain = port_rdstb(x, dstls, ck, cb, **kw)
    want = jax_rdstb(monkeypatch, x, dstls, ck, cb, **kw)
    assert np.isfinite(staged).all()
    assert rel_err(staged, plain) <= TOL
    assert rel_err(staged, want) <= TOL


def _pair_inputs(c, nh, hw, ws, shift, seed):
    rng = np.random.default_rng(seed)
    nw = (hw[0] // ws) * (hw[1] // ws)
    x = rng.normal(0, 1.0, (2 * nw, ws * ws, c)).astype(np.float32)
    pa, ba = _block_params(rng, c), _bias(rng, nh, *hw, ws, False)
    pb, bb = _block_params(rng, c), _bias(rng, nh, *hw, ws, shift > 0)
    return x, pa, ba, pb, bb


# (c, nh, (h, w), ws, shift, softmax)
PAIRS = {
    "c12_shift4_stable": (12, 3, (16, 24), 8, 4, "stable"),
    "c12_shift0_clamp": (12, 3, (16, 24), 8, 0, "clamp"),
    "c60_shift4_clamp": (60, 6, (16, 24), 8, 4, "clamp"),
    "c60_shift4_stable_mm": (60, 6, (16, 24), 8, 4, "stable_mm"),
    "c90_shift4_stable_bc": (90, 6, (16, 16), 8, 4, "stable_bc"),
    "window4_c12_shift2": (12, 3, (12, 16), 4, 2, "stable"),
}


def _port_pair(x, pa, ba, pb, bb, nh, hw, ws, shift, softmax):
    t = torch.from_numpy
    plan_a = sb.plan_fast_block([t(p) for p in pa], t(ba), num_heads=nh,
                                route="stage")
    plan_b = sb.plan_fast_block([t(p) for p in pb], t(bb), num_heads=nh,
                                route="stage")
    kw = dict(num_heads=nh, x_size=hw, window_size=ws, shift=shift,
              softmax=softmax)
    xb = t(x).bfloat16()
    args = (xb, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias)
    staged = sp.swin_pair_staged_reference(*args, **kw)
    before = sp.run_swin_pair.launches
    plain = sp.run_swin_pair(xb, plan_a, plan_b, **kw)
    assert sp.run_swin_pair.launches == before  # CPU: the plain version
    assert torch.equal(plain, sp.swin_pair_reference(*args, **kw))
    return staged.float().numpy(), plain.float().numpy()


@pytest.mark.parametrize("case", list(PAIRS))
def test_pair_staged_matches_plain(case):
    c, nh, hw, ws, shift, softmax = PAIRS[case]
    x, pa, ba, pb, bb = _pair_inputs(c, nh, hw, ws, shift, seed=31)
    staged, plain = _port_pair(x, pa, ba, pb, bb, nh, hw, ws, shift,
                               softmax)
    assert np.isfinite(staged).all()
    assert rel_err(staged, plain) <= TOL


@pytest.mark.parametrize("case", ["c12_shift4_stable", "c60_shift4_clamp"])
def test_pair_staged_matches_jax(monkeypatch, case):
    c, nh, hw, ws, shift, softmax = PAIRS[case]
    x, pa, ba, pb, bb = _pair_inputs(c, nh, hw, ws, shift, seed=32)
    if softmax == "stable":
        monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    bf = jnp.bfloat16
    want = np.asarray(jax_sb.fused_swin_pair(
        jnp.asarray(x).astype(bf), [jnp.asarray(p) for p in pa],
        jnp.asarray(ba).astype(bf), [jnp.asarray(p) for p in pb],
        jnp.asarray(bb).astype(bf), num_heads=nh, x_size=hw,
        window_size=ws, shift=shift, interpret=True).astype(jnp.float32))
    clear_kernel_caches()
    staged, _ = _port_pair(x, pa, ba, pb, bb, nh, hw, ws, shift, softmax)
    assert rel_err(staged, want) <= TOL


@pytest.mark.parametrize("hw,ws,shift", [((16, 24), 8, 4), ((40, 32), 8, 4),
                                         ((12, 16), 4, 2), ((16, 24), 8, 0)])
def test_window_pixels_is_the_relayout(hw, ws, shift):
    """Row r of window wi gathered at ``window_pixels`` is what
    ``shift_relayout`` puts there."""
    h, w = hw
    img = torch.arange(h * w, dtype=torch.float32).reshape(1, h * w, 1)
    rows = sp.shift_relayout(
        sp.window_partition(img.reshape(1, h, w, 1), ws).reshape(
            -1, ws * ws, 1), hw, ws, shift)
    assert torch.equal(rows.reshape(-1).long(),
                       wb.window_pixels(h, w, ws, shift).reshape(-1))


@pytest.mark.parametrize("c,hidden,growth", [(60, 120, 30), (90, 180, 30),
                                             (120, 240, 0), (12, 24, 6),
                                             (128, 512, 0)])
def test_stage_layout_unpacks_to_kernel_layout(c, hidden, growth):
    rng = np.random.default_rng(c + hidden)
    p = sb.FastParams(*[torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dt) for s, dt in (
            ((c, 3 * c), torch.bfloat16), ((3 * c,), torch.float32),
            ((c, c), torch.bfloat16), ((c,), torch.bfloat16),
            ((c, hidden), torch.bfloat16), ((hidden,), torch.float32),
            ((hidden, c), torch.bfloat16), ((c,), torch.bfloat16))])
    layout = sb.kernel_layout(p)
    cp, hp = layout[2].shape[0], layout[4].shape[0]
    adapter = None
    if growth:
        adapter = torch.from_numpy(rng.normal(size=(growth, cp)).astype(
            np.float32)).bfloat16()
    nh = 6 if c % 6 == 0 else 4
    stage = wb.stage_layout(layout, c, nh, adapter)
    g = wb.make_geom(64, c, nh, hidden)
    sizes = [n * k for n, k in wb.gemm_shapes(
        g, wb._round_up(growth, 32) if growth else 0)]
    assert stage[0].numel() == sum(sizes)
    back = wb.unpack_stage_layout(stage, c, nh, cp, hp, growth)
    for got, want in zip(back, layout + ((adapter,) if growth else ())):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("n,nh,bw", [(64, 6, 20), (64, 3, 1), (16, 6, 80)])
def test_stage_bias_unpacks_to_the_packed_bias(n, nh, bw):
    """The fragment-ordered bias holds every entry once, and unpacks to
    the packed bias bitwise; lane 4 g + t's first word of an item is the
    pair (row g, keys 2 t, 2 t + 1) of head h."""
    rng = np.random.default_rng(n + nh)
    packed = torch.from_numpy(rng.normal(size=(bw, n, nh * n)).astype(
        np.float32)).bfloat16()
    flat = wb.stage_bias(packed, nh)
    assert flat.numel() == packed.numel()
    assert torch.equal(wb.unpack_stage_bias(flat, nh, n), packed)
    words = flat.reshape(bw, nh, n // 16, 32, n // 4, 2)
    b = packed.reshape(bw, n, nh, n)
    for w, h, mt, g, t in ((0, nh - 1, 0, 3, 2), (bw - 1, 0, n // 16 - 1,
                                                  7, 1)):
        row = 16 * mt + g
        assert torch.equal(words[w, h, mt, 4 * g + t, 0],
                           b[w, row, h, 2 * t:2 * t + 2])
        assert torch.equal(words[w, h, mt, 4 * g + t, 1],
                           b[w, row + 8, h, 2 * t:2 * t + 2])


@pytest.mark.parametrize("c0,ccat", [(60, 150), (12, 30), (128, 280)])
def test_conv_panels_unpack_to_tap_rows(c0, ccat):
    rng = np.random.default_rng(c0)
    wc = torch.from_numpy(rng.normal(size=(9 * ccat, c0)).astype(
        np.float32)).bfloat16()
    flat = wb.conv_panels(wc, c0, ccat)
    assert flat.numel() == 9 * wb._round_up(c0, 32) * wb._round_up(ccat, 16)
    assert torch.equal(wb.unpack_conv_panels(flat, c0, ccat), wc)


def _shipped(name):
    p = ParametersLoader(str(ROOT / "config_files" / name))
    ws = p.rdst_window_size[0]
    return (ws * ws, p.rdst_embed_dim, p.rdst_growth_rate,
            p.rdst_rdb_depths[0], p.rdst_num_heads[0],
            float(p.swin_hidden_ratio))


# the gate's answer per shipped RDST config, bf16 or int8 qkv: W96's
# DSTLs at C = 144 / 192 (and every int8 stage) run the token-parallel
# stages, so it is admitted too
GATE = {name: True for name in RDST_CONFIGS}


@pytest.mark.parametrize("name", RDST_CONFIGS)
def test_shipped_rdst_gate_and_stage_smem(name):
    n, c0, g, nb, nh, ratio = _shipped(name)
    for int8 in (False, True):
        assert rb.rdstb_kernel_supports(n, c0, g, nb, nh, ratio,
                                        int8) is GATE[name]
    for ws in (8, 4):  # the shipped window and the 16-token one
        n = ws * ws
        for int8 in (False, True):
            if not rb.rdstb_kernel_supports(n, c0, g, nb, nh, ratio, int8):
                continue
            smem = rb.rdstb_stage_smem_bytes(n, c0, g, nb, nh, ratio, int8)
            assert len(smem) == 2 * nb + 1
            assert all(0 < s <= wb.SMEM_OPTIN for s in smem), smem
            routes = rb.dstl_routes(c0, g, nb, int8)
            for d, route in enumerate(routes):
                c = c0 + d * g
                hid = int(c * ratio)
                # the route rule: the window body up to C = 120 with bf16
                # qkv, the token-parallel stages otherwise
                assert route == ("window" if c <= 120 and not int8
                                 else "tokens")
                assert sp.pair_kernel_supports(n, c, nh, hid, int8)
                if route == "window":
                    assert 0 < sp.pair_stage_smem_bytes(n, c, nh, hid) \
                        <= wb.SMEM_OPTIN


def test_stage_fit_of_the_flagship_widths():
    """The stage kernels at C = 60 / 90 / 120: two consumer warpgroups and
    at least two ring slots in an H100 block's shared memory."""
    for c, nwg in ((60, 2), (90, 2), (120, 2)):
        for ng in (0, 32):
            f = wb.stage_fit(wb.make_geom(64, c, 6, 2 * c), ng)
            assert f.nwg == nwg and 2 <= f.nslots <= wb.MAX_SLOTS
            assert f.smem <= wb.SMEM_OPTIN
    assert wb.conv_smem_bytes(60, 150) <= wb.SMEM_OPTIN // 2
