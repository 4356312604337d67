"""The int8 ``mlp``, ``proj`` and ``conv`` groups (``pallas_quant``) of the
port's fast block, pair and RDSTB against the JAX package on the CPU.

* the weight quantization of fc1, fc2, the projection and the RDSTB conv
  rows bit-equal to JAX's ``quantize_weight`` on the committed W96 and
  SwinIR-std blocks, folded by each package from the same weights;
* ``quant.quant_dyn`` bit-equal to ``_quant_dyn``, ties included;
* the scale groups (``quant.block_group_windows``, ``pair_group_windows``,
  ``rdstb_group_images``) equal to the grid each JAX wrapper hands
  ``pallas_call``, read from ``jax.make_jaxpr`` on ``ShapeDtypeStruct``
  inputs (nothing runs): the E1 / W96 / SwinIR-std bucket-64 geometries,
  odd batches, the tester's 57- and 58-slice patients, a geometry whose
  whole image does not fit (the chunked grid) and the 'pack' mode;
* the plain fast block, pair and RDSTB with ``mlp``, ``proj``, ``conv``
  (RDSTB) and ``all`` against the JAX kernels in interpret mode
  (``RDST_TPU_PALLAS_INTERPRET=1``), at 2 and 3 images so that groups of
  two images and of one are both seen: <= 0.02 relative max error;
* a small E1-shaped bf16 model with ``pallas_quant='all'`` against the
  JAX model, through the weight carry-over that feeds both.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quant_groups.py``
(about a minute in one process).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import rdstb_block as jrb
from rdst_tpu.kernels import swin_block as jsb
from rdst_tpu.models.rdst import RDSTSR as JaxRDSTSR
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_rdstsr, export_swinir
from rdst_tpu_torch.kernels import quant
from rdst_tpu_torch.kernels import rdstb_block as rb
from rdst_tpu_torch.kernels import swin_block as sb
from rdst_tpu_torch.kernels import swin_pair as sp
from rdst_tpu_torch.models.rdst import RDSTSR, set_kernel_mode
from test_torch_model import _random_tree
from test_torch_rdstb_stages import (_bias, _block_params, _torch_dstls,
                                     random_rdstb)

REPO = pathlib.Path(__file__).resolve().parents[1]
W96 = REPO / "weights" / "rdst_w96_40k_best_oasis20_x4.msgpack"
STD = REPO / "weights" / "swinir_std_40k_best_oasis20_x4.msgpack"
TOL = 0.02
ALL = frozenset(quant.GROUPS)
BF = jnp.bfloat16


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------- weights


def _fold_both(params, c, nh):
    """The folded bf16 (wqkv, w1) and bf16 (wproj, w2) of a 12-param
    bundle by each package: (jax list, torch FastParams)."""
    jp = jsb.prep_block_params([jnp.asarray(a) for a in params], c, nh, BF)
    tp = sb.fast_params([torch.from_numpy(a) for a in params], c, nh)
    return jp, tp


def _assert_weight_quant(jp, tp):
    q = quant.block_quant(tp, ALL)
    for jw, act, tq, ts in ((jp[8], 1 / jsb._QX, q.mlp.w1q, q.mlp.w1s),
                            (jp[10], 1.0, q.mlp.w2q, q.mlp.w2s),
                            (jp[2], 1.0, q.proj.wq, q.proj.ws)):
        wq, ws = jsb.quantize_weight(jw, act_step=act)
        np.testing.assert_array_equal(np.asarray(wq), tq.numpy())
        np.testing.assert_array_equal(np.asarray(ws).reshape(-1),
                                      ts.numpy())
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32


def test_weight_quant_bit_equal_on_swinir_std():
    """Every 6th of SwinIR-std's 36 blocks (C = 180): w1 (LN2 folded), w2
    and wproj quantized bit-equal."""
    sd = export_swinir(mr.read_snapshot(str(STD)))
    for i in range(6):
        pre = f"layers.{i}.residual_group.blocks.{i}."
        g = {k[len(pre):]: np.array(v, np.float32) for k, v in sd.items()
             if k.startswith(pre)}
        params = [g["attn.qkv.weight"].T, g["attn.qkv.bias"],
                  g["attn.proj.weight"].T, g["attn.proj.bias"],
                  g["norm1.weight"], g["norm1.bias"], g["norm2.weight"],
                  g["norm2.bias"], g["mlp.fc1.weight"].T, g["mlp.fc1.bias"],
                  g["mlp.fc2.weight"].T, g["mlp.fc2.bias"]]
        _assert_weight_quant(*_fold_both(params, 180, 6))


def test_weight_quant_bit_equal_on_w96():
    """The first RDSTB of W96 (C = 96 / 144 / 192): block a of every DSTL
    (w1, w2, wproj) and the conv's tap-major rows, bit-equal."""
    from test_torch_w96 import snapshot_rdstb

    dstls, ck, _ = snapshot_rdstb(16, 16, 4)
    c = 96
    for d in dstls:
        _assert_weight_quant(*_fold_both(d["blocks"][0][0], c, 6))
        c += 48
    jwc = jnp.asarray(ck).astype(BF).reshape(9 * c, 96)
    wq, ws = jsb.quantize_weight(jwc, act_step=1.0)
    cq = quant.conv_quant(rb.conv_rows(torch.from_numpy(ck)))
    np.testing.assert_array_equal(np.asarray(wq), cq.wq.numpy())
    np.testing.assert_array_equal(np.asarray(ws).reshape(-1), cq.ws.numpy())


def test_quant_dyn_bit_equal():
    """Same float32 values in: the same int8 rows and dequant step out,
    over one tensor and over groups of it (each group one JAX program);
    ties (x.5 steps of the group's scale) round half to even in both."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, (6, 64, 40)) * rng.uniform(0.01, 30, (6, 1, 1))
         ).astype(np.float32)
    ties = np.concatenate([np.arange(-254, 255) / 2.0, [127.0]]).astype(
        np.float32)[None, None] * np.float32(0.37)
    for v, groups in ((x, 1), (x, 3), (x, 6), (ties, 1),
                      (np.zeros((2, 4, 4), np.float32), 2)):
        q, dq = quant.quant_dyn(torch.from_numpy(v), groups)
        for g, part in enumerate(np.split(v, groups)):
            jq, jdq = jsb._quant_dyn(jnp.asarray(part))
            np.testing.assert_array_equal(
                np.asarray(jq), q.numpy()[g * len(part):(g + 1) * len(part)])
            assert np.float32(jdq) == dq.numpy()[g]


def test_every_subset_is_accepted_and_unknown_raises():
    for groups in ({"mlp"}, {"proj", "conv"}, {"qkv", "mlp", "proj"}, ALL):
        assert quant.check_ported(groups) == quant.mm_quant_groups(groups)
    with pytest.raises(ValueError, match="unknown int8 groups"):
        quant.check_ported({"mlp", "attn"})


# ---------------------------------------------------------- scale groups


def _pallas_grid(fn, *args):
    """The grid of the one ``pallas_call`` in fn's jaxpr."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(tuple(eqn.params["grid_mapping"].grid))
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr if hasattr(sub.jaxpr, "eqns")
                             else sub.jaxpr.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    assert len(found) == 1, found
    return found[0]


def _s(*shape, dt=BF):
    return jax.ShapeDtypeStruct(shape, dt)


def _block_args(c, nh, hidden, n, bw_heads):
    f32 = jnp.float32
    return [_s(c, 3 * c), _s(3 * c), _s(c, c), _s(c), _s(c, dt=f32),
            _s(c, dt=f32), _s(c, dt=f32), _s(c, dt=f32), _s(c, hidden),
            _s(hidden), _s(hidden, c), _s(c), _s(bw_heads, n, n)]


# (images, nW, C, heads, hidden, window): E1 / W96 / SwinIR-std at bucket
# 64 (40x32 LR, 20 windows), odd batches, the tester's 57- and 58-slice
# patients (24x24 padded patches, 9 windows)
BLOCK_GEOMS = [(64, 20, 60, 6, 120, 8), (64, 20, 120, 6, 240, 8),
               (64, 20, 180, 6, 360, 8), (64, 20, 192, 6, 384, 8),
               (3, 20, 90, 6, 180, 8), (57, 9, 180, 6, 360, 8),
               (58, 9, 180, 6, 360, 8), (5, 4, 96, 6, 192, 8)]


@pytest.mark.parametrize("shifted", [False, True], ids=["shared", "per_win"])
@pytest.mark.parametrize("geom", BLOCK_GEOMS, ids=lambda g: "x".join(
    map(str, g[:3])))
def test_block_groups_equal_jax_grid(monkeypatch, geom, shifted):
    b, nw, c, nh, hid, ws = geom
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    n = ws * ws
    bw = nw if shifted else 1
    grid = _pallas_grid(
        lambda x, *a: jsb._fused_swin_block_jit(
            x, *a, num_heads=nh, windows_per_image=nw,
            images_per_program=2, interpret=True, quant=frozenset()),
        _s(b * nw, n, c), *_block_args(c, nh, hid, n, nh * bw))
    gw = quant.block_group_windows(b * nw, nw, n, c, nh, hid, bw)
    assert grid == (b * nw // gw,)
    assert 0 < gw <= b * nw and (b * nw) % gw == 0


@pytest.mark.parametrize("softmax", ["", "clamp"])
def test_chunked_grid_equal_jax(monkeypatch, softmax):
    """SwinIR-std on a 160x128 LR image (320 windows): no whole image fits
    the JAX budget, so the grid steps over window chunks t | nW."""
    nw, c, nh, hid, n = 320, 180, 6, 360, 64
    if softmax:
        monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    else:
        monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    for bw in (1, nw):
        grid = _pallas_grid(
            lambda x, *a: jsb._fused_swin_block_jit(
                x, *a, num_heads=nh, windows_per_image=nw,
                images_per_program=2, interpret=True, quant=frozenset()),
            _s(2 * nw, n, c), *_block_args(c, nh, hid, n, nh * bw))
        gw = quant.block_group_windows(2 * nw, nw, n, c, nh, hid, bw,
                                       softmax=softmax)
        assert gw < nw and nw % gw == 0
        assert grid == (2 * nw // gw,)


def test_pack_groups_equal_jax_grid(monkeypatch):
    """'pack' (two windows a lane row at C <= 64): the JAX grid counts
    window pairs; the port's groups are the windows those pairs hold."""
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    for b, nw in ((64, 20), (3, 4)):
        grid = _pallas_grid(
            lambda x, *a: jsb._fused_swin_block_jit(
                x, *a, num_heads=6, windows_per_image=nw,
                images_per_program=2, pack=2, interpret=True,
                quant=frozenset()),
            _s(b * nw, 64, 60), *_block_args(60, 6, 120, 64, 6 * nw))
        gw = quant.block_group_windows(b * nw, nw, 64, 60, 6, 120, nw,
                                       pack=2)
        assert grid == (b * nw // gw,)


PAIR_GEOMS = [(64, (40, 32), 60), (64, (40, 32), 120), (64, (40, 32), 96),
              (64, (40, 32), 192), (3, (40, 32), 90), (57, (24, 24), 144),
              (58, (24, 24), 144)]


@pytest.mark.parametrize("geom", PAIR_GEOMS, ids=lambda g: f"{g[0]}x{g[2]}")
def test_pair_groups_equal_jax_grid(monkeypatch, geom):
    b, (h, w), c = geom
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    nh, n, hid = 6, 64, 2 * c
    nw = (h // 8) * (w // 8)
    blk = _block_args(c, nh, hid, n, nh)[:12]
    grid = _pallas_grid(
        lambda x, pa, ba, pb, bb: jsb._fused_swin_pair_jit(
            x, pa, ba, pb, bb, num_heads=nh, x_size=(h, w), window_size=8,
            shift=4, images_per_program=2, interpret=True,
            quant=frozenset()),
        _s(b * nw, n, c), blk, _s(nh, n, n), blk, _s(nh * nw, n, n))
    gw = quant.pair_group_windows(b * nw, nw, n, c, nh, hid)
    assert grid == (b * nw // gw,)


# (images, LR, C0, growth, nb, ipp): E1 and W96 at bucket 64, the tester's
# patients, an odd batch with ipp 2
RDSTB_GEOMS = [(64, (40, 32), 60, 30, 3, 1), (64, (40, 32), 96, 48, 3, 1),
               (57, (24, 24), 60, 30, 3, 1), (57, (24, 24), 60, 30, 3, 2),
               (58, (24, 24), 60, 30, 3, 2), (5, (16, 16), 96, 48, 3, 2),
               (4, (16, 16), 24, 12, 2, 2)]


@pytest.mark.parametrize("geom", RDSTB_GEOMS,
                         ids=lambda g: f"{g[0]}x{g[2]}ipp{g[5]}")
def test_rdstb_groups_equal_jax_grid(monkeypatch, geom):
    b, (h, w), c0, g, nb, ipp = geom
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    nh, n = 6, 64
    nw = (h // 8) * (w // 8)
    dstls, c = [], c0
    for _ in range(nb):
        blk = _block_args(c, nh, 2 * c, n, nh)[:12]
        dstls.append({"blocks": [(blk, _s(nh, n, n)),
                                 (blk, _s(nh * nw, n, n))],
                      "adapter": (_s(c, g), _s(g), _s(g, dt=jnp.float32),
                                  _s(g, dt=jnp.float32))})
        c += g
    grid = _pallas_grid(
        lambda x, d, ck, cb: jrb._fused_rdstb_impl(
            x, d, ck, cb, num_heads=nh, x_size=(h, w), window_size=8,
            shift=4, growth=g, images_per_program=ipp, interpret=True,
            quant=frozenset()),
        _s(b, h * w, c0), dstls, _s(3, 3, c, c0),
        _s(c0, dt=jnp.float32))
    monkeypatch.setenv(quant.ENV_IPP, str(ipp))
    gi = quant.rdstb_group_images(b, nw, n, c0, g, nb, nh, 2.0)
    assert grid == (b // gi,)


def test_ipp_env_reaches_the_rules(monkeypatch):
    monkeypatch.setenv(quant.ENV_IPP, "1")
    assert quant.block_group_windows(64 * 20, 20, 64, 60, 6, 120, 1) == 20
    monkeypatch.delenv(quant.ENV_IPP)
    assert quant.block_group_windows(64 * 20, 20, 64, 60, 6, 120, 1) == 40
    assert quant.images_per_program("rdstb") == 1


# ---------------------------------------------------------- kernels


def _jax_block_params(p):
    return [jnp.asarray(a) if i in (4, 5, 6, 7) else jnp.asarray(a, BF)
            for i, a in enumerate(p)]


# (groups, images): each group on 3 images (groups of one image, as an odd
# batch gives at ipp 2), all of them on 2 (one group of two)
CASES = [("mlp", 3), ("proj", 3), ("all", 3), ("all", 2)]


@pytest.mark.parametrize("groups,images", CASES)
def test_plain_fast_block_matches_jax(monkeypatch, groups, images):
    """The fast block's plain version against ``fused_swin_block`` in
    interpret mode: C = 24, 2 heads, 4 windows an image, per-window bias,
    'stable'."""
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    clear_kernel_caches()
    q = ALL if groups == "all" else frozenset({groups})
    rng = np.random.default_rng(11 + images)
    c, nh, n, nw = 24, 2, 64, 4
    p = _block_params(rng, c)
    bias = rng.normal(0, 1, (nh * nw, n, n)).astype(np.float32)
    x = rng.normal(0, 1, (images * nw, n, c)).astype(np.float32)
    want = np.asarray(jsb.fused_swin_block(
        jnp.asarray(x, BF), *_jax_block_params(p), jnp.asarray(bias, BF),
        num_heads=nh, windows_per_image=nw, images_per_program=2,
        interpret=True, quant=q).astype(jnp.float32))
    clear_kernel_caches()
    plan = sb.plan_fast_block([torch.from_numpy(a) for a in p],
                              torch.from_numpy(bias).bfloat16(),
                              num_heads=nh, quant=q)
    assert plan.route == "tokens" and plan.int8_mask == (
        1 * ("proj" in q) + 2 * ("mlp" in q))
    got = sb.run_fast_block(torch.from_numpy(x).bfloat16(), plan,
                            num_heads=nh, windows_per_image=nw,
                            softmax="stable").float().numpy()
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("groups,images", CASES)
def test_plain_pair_matches_jax(monkeypatch, groups, images):
    """The pair's plain and staged versions against ``fused_swin_pair`` in
    interpret mode: C = 24, 2 heads, 16x16 images, shift 4, 'clamp'."""
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "clamp")
    clear_kernel_caches()
    q = ALL if groups == "all" else frozenset({groups})
    hw, shift, c, nh, ws = (16, 16), 4, 24, 2, 8
    rng = np.random.default_rng(21 + images)
    pa, pb = _block_params(rng, c), _block_params(rng, c)
    ba, bb = _bias(rng, nh, *hw, ws, False), _bias(rng, nh, *hw, ws, True)
    x = rng.normal(0, 0.5, (images * 4, ws * ws, c)).astype(np.float32)
    want = np.asarray(jsb.fused_swin_pair(
        jnp.asarray(x).astype(BF), [jnp.asarray(a) for a in pa],
        jnp.asarray(ba).astype(BF), [jnp.asarray(a) for a in pb],
        jnp.asarray(bb).astype(BF), num_heads=nh, x_size=hw, window_size=ws,
        shift=shift, interpret=True, quant=q).astype(jnp.float32))
    clear_kernel_caches()
    t = torch.from_numpy
    plan_a = sp.plan_pair_block([t(a) for a in pa], t(ba).bfloat16(),
                                num_heads=nh, quant=q)
    plan_b = sp.plan_pair_block([t(a) for a in pb], t(bb).bfloat16(),
                                num_heads=nh, quant=q)
    xb = t(x).bfloat16()
    kw = dict(num_heads=nh, x_size=hw, window_size=ws, shift=shift,
              softmax="clamp")
    plain = sp.run_swin_pair(xb, plan_a, plan_b, **kw).float().numpy()
    gw = quant.pair_group_windows(images * 4, 4, 64, c, nh, 2 * c,
                                  softmax="clamp")
    assert gw == (8 if images == 2 else 4)
    staged = sp.swin_pair_staged_reference(
        xb, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias,
        quant_a=plan_a.quant, quant_b=plan_b.quant, group_windows=gw,
        **kw).float().numpy()
    assert rel(staged, plain) <= TOL
    assert rel(plain, want) <= TOL and rel(staged, want) <= TOL


@pytest.mark.parametrize("groups,images,ipp", [
    ("mlp", 3, 1), ("proj", 3, 2), ("conv", 3, 2), ("conv", 2, 2),
    ("all", 3, 1), ("all", 2, 2)])
def test_plain_rdstb_matches_jax(monkeypatch, groups, images, ipp):
    """The RDSTB's plain and staged versions against ``fused_rdstb`` in
    interpret mode: 2 DSTLs from C0 = 24 growing by 12, 2 heads, 16x16
    images, shift 4, pre-norm adapters, 'stable_bc', ``ipp`` images a JAX
    program (3 images at ipp 2: groups of one)."""
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "stable_bc")
    clear_kernel_caches()
    q = ALL if groups == "all" else frozenset({groups})
    hw, shift, c0, g, nb, nh, ws = (16, 16), 4, 24, 12, 2, 2, 8
    dstls, ck, cb = random_rdstb(c0, g, nb, nh, *hw, ws, shift, True,
                                 seed=31 + images)
    x = np.random.default_rng(32).normal(0, 0.5, (images, 256, c0)).astype(
        np.float32)
    jd = [{"blocks": [([jnp.asarray(a) for a in params],
                       jnp.asarray(bias).astype(BF))
                      for params, bias in d["blocks"]],
           "adapter": tuple(jnp.asarray(a) for a in d["adapter"])}
          for d in dstls]
    want = np.asarray(jrb.fused_rdstb(
        jnp.asarray(x).astype(BF), jd, jnp.asarray(ck), jnp.asarray(cb),
        num_heads=nh, x_size=hw, window_size=ws, shift=shift, growth=g,
        adapter_prenorm=True, images_per_program=ipp, interpret=True,
        quant=q).astype(jnp.float32))
    clear_kernel_caches()
    plan = rb.plan_rdstb(_torch_dstls(dstls), torch.from_numpy(ck),
                         torch.from_numpy(cb), num_heads=nh, growth=g,
                         adapter_prenorm=True, quant=q)
    assert (plan.conv is not None) == ("conv" in q)
    assert plan.routes == (["window"] * nb if groups == "conv"
                           else ["tokens"] * nb)
    xb = torch.from_numpy(x).bfloat16()
    kw = dict(num_heads=nh, x_size=hw, window_size=ws, shift=shift)
    monkeypatch.setenv(quant.ENV_IPP, str(ipp))
    plain = rb.run_rdstb(xb, plan, softmax="stable_bc", **kw).float().numpy()
    gi = quant.rdstb_group_images(images, 4, 64, c0, g, nb, nh, 2.0)
    assert gi == (2 if (images, ipp) == (2, 2) else 1)
    staged = rb.rdstb_staged_reference(
        xb, plan.dstls, plan.wc, plan.bc, growth=g, adapter_prenorm=True,
        softmax="stable_bc", conv=plan.conv, group_images=gi,
        **kw).float().numpy()
    assert rel(staged, plain) <= TOL
    assert rel(plain, want) <= TOL and rel(staged, want) <= TOL


def test_kernel_counts_by_group():
    assert [sb.token_fwd_kernels(m) for m in range(4)] == [5, 6, 7, 8]
    tokens = ["tokens"] * 3
    assert rb.rdstb_kernel_count(tokens, True, 3, True) == \
        2 + 3 * (2 * 8 + 2)
    assert rb.rdstb_kernel_count(["window"] * 3, False, 0, True) == 8


# ---------------------------------------------------------- the model

SMALL = dict(in_chans=1, sr_scale=2, embed_dim=12, dense_layer_depths=(2, 2),
             num_heads=(3, 3), window_size=(8, 8), rdb_depths=(2, 2),
             mlp_ratio=2.0, growth_rate=6, build_resolution=(16, 16))
ROUTES = {"rdstb": "fused_rdstb", "pair": "fused_swin_pair",
          "swin": "fused_swin_block"}


@pytest.fixture(scope="module")
def small_params():
    model = JaxRDSTSR(**SMALL, dtype=jnp.bfloat16)
    x = np.zeros((1, 16, 16, 1), np.float32)
    init = jax.jit(lambda k, x: model.init(k, x))(jax.random.PRNGKey(0), x)
    return _random_tree(init, 23)


@pytest.mark.parametrize("mode", ["rdstb", "pair", "swin"])
def test_small_model_all_groups_matches_jax(monkeypatch, small_params,
                                            mode):
    """An E1-shaped bf16 RDST (2 RDSTBs, embed 12, growth 6, 3 heads,
    window 8) with ``pallas_quant='all'`` on three 16x16 slices, same mode
    on both sides, the flax weights carried into the port by
    ``export_rdstsr``: <= 0.02 relative max error."""
    x = np.random.default_rng(8).normal(0, 0.3, (3, 16, 16, 1)).astype(
        np.float32)
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS", mode)
    monkeypatch.setenv("RDST_TPU_PALLAS_QUANT", "all")
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    clear_kernel_caches()
    jm = JaxRDSTSR(**SMALL, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(
        small_params, jnp.asarray(x).astype(BF)).astype(jnp.float32))
    clear_kernel_caches()

    model = RDSTSR(**SMALL, dtype=torch.bfloat16)
    sd = export_rdstsr(small_params, model.mean, model.std)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    model.eval()
    assert set_kernel_mode(model, mode, "stable", ALL) == [ROUTES[mode]] * 2
    assert model.quant == ALL
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (3, 32, 32, 1)
    assert rel(got, want) <= TOL


def test_tester_config_key_reaches_the_model(tmp_path):
    """``python -m rdst_tpu_torch.test ... pallas_quant='all'``: the
    command line's override reaches the tester's model (the E1 config and
    its committed weights, bf16 on the CPU)."""
    from types import SimpleNamespace

    from rdst_tpu_torch import cli
    from rdst_tpu_torch.runners.tester import SRTester

    args = SimpleNamespace(
        config_file=str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini"),
        gpu_id=-1,
        overrides=["pallas_quant='all'", "inference_dtype='bfloat16'",
                   f"output_dir='{tmp_path}'",
                   "well_trained_single_scale_model_g="
                   "'weights/rdst_e1_40k_best_oasis20_x4.msgpack'"])
    tester = SRTester(cli._load_paras(args), device="cpu")
    tester.setup()
    assert tester.model.quant == ALL and tester.model.kernel_mode == "rdstb"
    assert tester.manifest["pallas_quant"] == sorted(ALL)
    assert tester.manifest["routes"] == ["fused_rdstb"] * 8
