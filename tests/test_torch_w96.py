"""RDST-W96 x4 (``config_files/rdst_w96_40k_oasis20_x4.ini``: embed 96,
growth 48, 8 RDSTBs of 3 DSTLs at C = 96 / 144 / 192, 6 heads, window 8,
MLP 2C, pre-norm adapters, ``pallas_quant = 'qkv'``) from
``rdst_tpu_torch`` on the CPU, against ``rdst_tpu``:

* f32 as shipped: every Swin block routed to the f32 block kernel (its
  plain version here), ``LiveModel(device='cpu')`` against the JAX
  ``LiveModel`` with the committed 40k weights at LR 16x16 and 40x32:
  <= 1e-4 max abs (the f32 bar of the port);
* the RDSTB and the pair with int8 qkv at the W96 widths: the port's
  plain and staged versions against the JAX ``fused_rdstb`` /
  ``fused_swin_pair`` with ``quant={'qkv'}`` in interpret mode
  (``RDST_TPU_PALLAS_INTERPRET=1``, as ``tests/test_kernels.py`` runs
  them): <= 0.02 relative max error (``test_kernels.py``'s bar: both
  quantize the same rows with the same steps and round to bf16 at the
  same places; the sums and the approximate reciprocal differ). Cases:
  the committed first RDSTB on a 16x16 image, seeded weights with post-
  and pre-norm adapters, shift 0 and 4, 'clamp' and 'stable_bc';
* the W96 bf16 model in mode rdstb against the JAX bf16 rdstb path in
  interpret mode (<= 0.02), and both against the JAX f32 model (< 0.05
  max, < 0.005 mean, relative): ``test_torch_model_bf16.py``'s bars;
* the routes: 8 RDSTB launches (mode rdstb) or 24 pairs (mode pair) a
  forward, and each stage in the design the route rule picks.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import rdstb_block as jax_rb
from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.serving import export as jax_export
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import rdstb_block as rb
from rdst_tpu_torch.kernels import swin_pair as sp
from rdst_tpu_torch.serving import export
from test_torch_rdstb_stages import (_bias, _block_params, _torch_dstls,
                                     random_rdstb)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_w96_40k_oasis20_x4.ini")
WEIGHTS = str(REPO / "weights" / "rdst_w96_40k_best_oasis20_x4.msgpack")
F32_TOL = 1e-4
TOL = 0.02
QKV = frozenset({"qkv"})
C0, GROWTH, NB, NH, WS = 96, 48, 3, 6, 8


def rel(got, want):
    d = np.abs(got - want)
    scale = np.abs(want).max()
    return float(d.max() / scale), float(d.mean() / scale)


def _paras(cls=ParametersLoader, **overrides):
    p = cls(CONFIG)
    p.set("well_trained_single_scale_model_g", WEIGHTS)
    for k, v in overrides.items():
        p.set(k, v)
    return p


@pytest.fixture(scope="module")
def jax_live():
    # one device: the JAX LiveModel pads every call to the mesh's data
    # axis (8 virtual CPU devices here), the port serves the one slice.
    # Its builder writes the config's kernel flags (pallas_quant='qkv')
    # to the process's environment: they are put back after this file
    saved = {k: v for k, v in os.environ.items() if k.startswith("RDST_TPU_")}
    yield jax_export.LiveModel(_paras(JaxParams, mesh_shape=[1]),
                               max_batch=1)
    for k in [k for k in os.environ if k.startswith("RDST_TPU_")]:
        del os.environ[k]
    os.environ.update(saved)


@pytest.fixture(scope="module")
def live():
    return export.LiveModel(_paras(), max_batch=1, device="cpu")


@pytest.mark.parametrize("hw", [(16, 16), (40, 32)], ids=["16x16", "40x32"])
def test_f32_as_shipped_matches_jax(live, jax_live, hw):
    m = live.manifest
    assert m["dtype"] == "float32" and m["pallas_kernels"] == "rdstb"
    assert m["pallas_quant"] is None  # int8 is dropped in f32, as in JAX
    assert m["routes"] == ["fused_swin_block"] * 8
    x = np.random.default_rng(hw[0]).random((1, *hw, 1), dtype=np.float32)
    got = live.predict(x, 4.0)
    want = np.asarray(jax_live.predict(x, 4.0))
    assert got.shape == want.shape == (1, 4 * hw[0], 4 * hw[1], 1)
    assert float(np.abs(got - want).max()) <= F32_TOL


def snapshot_rdstb(h, w, shift):
    """The first RDSTB of the committed W96 snapshot, JAX layout (its
    adapters are pre-norm: tail_0 the LN(C), tail_1 the Dense)."""
    tree = mr.read_snapshot(WEIGHTS)["params"]["body_0"]
    dstls = []
    for d in range(NB):
        layer = tree[f"body_{d}"]
        blocks = []
        for k in range(2):
            blk = layer["body"][f"blocks_{k}"]
            a = blk["attn"]
            params = [a["qkv"]["kernel"], a["qkv"]["bias"],
                      a["proj"]["kernel"], a["proj"]["bias"],
                      blk["norm1"]["scale"], blk["norm1"]["bias"],
                      blk["norm2"]["scale"], blk["norm2"]["bias"],
                      blk["mlp"]["fc1"]["kernel"], blk["mlp"]["fc1"]["bias"],
                      blk["mlp"]["fc2"]["kernel"], blk["mlp"]["fc2"]["bias"]]
            table = np.array(a["relative_position_bias_table"], np.float32)
            blocks.append(([np.array(p, np.float32) for p in params],
                           _table_bias(table, h, w, k == 1 and shift > 0,
                                       shift)))
        ln, dense = layer["tail_0"], layer["tail_1"]
        dstls.append({"blocks": blocks, "adapter": tuple(
            np.array(v, np.float32) for v in (
                dense["kernel"], dense["bias"], ln["scale"], ln["bias"]))})
    conv = tree["conv"]["conv"]
    return (dstls, np.array(conv["kernel"], np.float32),
            np.array(conv["bias"], np.float32))


def _table_bias(table, h, w, shifted, shift):
    from rdst_tpu.nn.swin import relative_position_index, shift_attention_mask

    n = WS * WS
    rel_b = table[relative_position_index(WS, WS).reshape(-1)].reshape(
        n, n, NH).transpose(2, 0, 1)
    if not shifted:
        return np.ascontiguousarray(rel_b, np.float32)
    nw = (h // WS) * (w // WS)
    return np.ascontiguousarray(
        (rel_b[:, None] + shift_attention_mask(h, w, WS, shift)[None])
        .reshape(NH * nw, n, n), np.float32)


def port_rdstb_int8(x, dstls, ck, cb, *, hw, shift, prenorm, softmax):
    """(staged, plain) versions of the port on one int8-qkv plan."""
    plan = rb.plan_rdstb(_torch_dstls(dstls), torch.from_numpy(ck),
                         torch.from_numpy(cb), num_heads=NH, growth=GROWTH,
                         adapter_prenorm=prenorm, quant=QKV)
    assert plan.routes == ["tokens"] * NB
    assert all(d.qa is not None and d.qb is not None for d in plan.dstls)
    xb = torch.from_numpy(x).bfloat16()
    kw = dict(num_heads=NH, x_size=hw, window_size=WS, shift=shift,
              growth=GROWTH, adapter_prenorm=prenorm, softmax=softmax)
    staged = rb.rdstb_staged_reference(xb, plan.dstls, plan.wc, plan.bc,
                                       **kw)
    plain = rb.rdstb_reference(xb, plan.dstls, plan.wc, plan.bc, **kw)
    return staged.float().numpy(), plain.float().numpy()


def jax_rdstb_int8(monkeypatch, x, dstls, ck, cb, *, hw, shift, prenorm,
                   softmax):
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
        num_heads=NH, x_size=hw, window_size=WS, shift=shift, growth=GROWTH,
        adapter_prenorm=prenorm, interpret=True,
        quant=QKV).astype(jnp.float32))
    clear_kernel_caches()
    return out


def test_committed_rdstb_int8_matches_jax(monkeypatch):
    """The committed first RDSTB, int8 qkv, as shipped (pre-norm, shift 4,
    'auto' -> clamp at the snapshot's stamp), on one 16x16 image."""
    hw, shift = (16, 16), 4
    dstls, ck, cb = snapshot_rdstb(*hw, shift)
    x = np.random.default_rng(31).normal(0, 1.0, (1, 256, C0)).astype(
        np.float32)
    staged, plain = port_rdstb_int8(x, dstls, ck, cb, hw=hw, shift=shift,
                                    prenorm=True, softmax="clamp")
    want = jax_rdstb_int8(monkeypatch, x, dstls, ck, cb, hw=hw, shift=shift,
                          prenorm=True, softmax="clamp")
    assert np.isfinite(staged).all()
    assert rel(staged, plain)[0] <= TOL
    assert rel(staged, want)[0] <= TOL and rel(plain, want)[0] <= TOL


# (adapter pre-norm, shift, softmax) of the seeded W96-width cases
SEEDED = {"postnorm_shift0_stable_bc": (False, 0, "stable_bc"),
          "prenorm_shift4_stable_bc": (True, 4, "stable_bc"),
          "postnorm_shift4_clamp": (False, 4, "clamp")}


@pytest.mark.parametrize("case", list(SEEDED))
def test_seeded_rdstb_int8_matches_jax(monkeypatch, case):
    prenorm, shift, softmax = SEEDED[case]
    hw = (16, 16)
    dstls, ck, cb = random_rdstb(C0, GROWTH, NB, NH, *hw, WS, shift,
                                 prenorm, seed=41)
    x = np.random.default_rng(42).normal(0, 0.5, (1, 256, C0)).astype(
        np.float32)
    staged, plain = port_rdstb_int8(x, dstls, ck, cb, hw=hw, shift=shift,
                                    prenorm=prenorm, softmax=softmax)
    want = jax_rdstb_int8(monkeypatch, x, dstls, ck, cb, hw=hw, shift=shift,
                          prenorm=prenorm, softmax=softmax)
    assert rel(staged, plain)[0] <= TOL
    assert rel(staged, want)[0] <= TOL and rel(plain, want)[0] <= TOL


@pytest.mark.parametrize("c", [96, 144, 192])
def test_pair_int8_matches_jax(monkeypatch, c):
    """The pair at each W96 width, int8 qkv, shift 4, 'clamp', on two
    16x16 images: the plain and staged versions against the JAX kernel."""
    hw, shift = (16, 16), 4
    rng = np.random.default_rng(c)
    pa, pb = _block_params(rng, c), _block_params(rng, c)
    ba, bb = _bias(rng, NH, *hw, WS, False), _bias(rng, NH, *hw, WS, True)
    x = rng.normal(0, 0.5, (2 * 4, WS * WS, c)).astype(np.float32)
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "clamp")
    clear_kernel_caches()
    bf = jnp.bfloat16
    want = np.asarray(jax_sb.fused_swin_pair(
        jnp.asarray(x).astype(bf), [jnp.asarray(p) for p in pa],
        jnp.asarray(ba).astype(bf), [jnp.asarray(p) for p in pb],
        jnp.asarray(bb).astype(bf), num_heads=NH, x_size=hw,
        window_size=WS, shift=shift, interpret=True,
        quant=QKV).astype(jnp.float32))
    clear_kernel_caches()
    t = torch.from_numpy
    plan_a = sp.plan_pair_block([t(p) for p in pa], t(ba).bfloat16(),
                                num_heads=NH, quant=QKV)
    plan_b = sp.plan_pair_block([t(p) for p in pb], t(bb).bfloat16(),
                                num_heads=NH, quant=QKV)
    assert plan_a.route == plan_b.route == "tokens"
    xb = t(x).bfloat16()
    kw = dict(num_heads=NH, x_size=hw, window_size=WS, shift=shift,
              softmax="clamp")
    before = sp.run_swin_pair.launches
    plain = sp.run_swin_pair(xb, plan_a, plan_b, **kw)
    assert sp.run_swin_pair.launches == before  # CPU: the plain version
    staged = sp.swin_pair_staged_reference(
        xb, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias,
        qkv_a=plan_a.qkv, qkv_b=plan_b.qkv, **kw)
    plain, staged = plain.float().numpy(), staged.float().numpy()
    assert rel(staged, plain)[0] <= TOL
    assert rel(plain, want)[0] <= TOL and rel(staged, want)[0] <= TOL


def test_bf16_model_matches_jax(monkeypatch, jax_live):
    """W96 in bf16 with int8 qkv (mode rdstb, as the shipped config asks)
    on one 16x16 slice: against the JAX bf16 rdstb path in interpret mode,
    and both against the JAX f32 model (its LiveModel, as shipped)."""
    x = np.random.default_rng(7).random((1, 16, 16, 1), dtype=np.float32)
    want32 = np.asarray(jax_live.predict(x, 4.0))
    flax_params = serialization.msgpack_restore(
        pathlib.Path(WEIGHTS).read_bytes())
    monkeypatch.setenv("RDST_TPU_PALLAS", "rdstb")
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "clamp")  # auto @ stamp
    monkeypatch.setenv("RDST_TPU_PALLAS_QUANT", "qkv")
    clear_kernel_caches()
    jm16 = jax_build(JaxParams(CONFIG), dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(lambda p, x: jm16.apply(p, x, 4.0))(
        flax_params, jnp.asarray(x).astype(jnp.bfloat16)).astype(
            jnp.float32))
    clear_kernel_caches()
    for name in ("RDST_TPU_PALLAS", "RDST_TPU_PALLAS_INTERPRET",
                 "RDST_TPU_PALLAS_SOFTMAX", "RDST_TPU_PALLAS_QUANT"):
        monkeypatch.delenv(name)

    live16 = export.LiveModel(_paras(inference_dtype="bfloat16"),
                              max_batch=1, device="cpu")
    m = live16.manifest
    assert (m["pallas_kernels"], m["pallas_softmax"], m["pallas_quant"]) \
        == ("rdstb", "clamp", ["qkv"])
    assert m["routes"] == ["fused_rdstb"] * 8
    before = rb.run_rdstb.launches
    got = live16.predict(x, 4.0)
    assert rb.run_rdstb.launches == before  # CPU: the plain version
    assert np.isfinite(got).all() and got.shape == want16.shape
    assert rel(got, want16)[0] <= TOL
    for y in (got, want16):
        mx, mean = rel(y, want32)
        assert mx < 0.05 and mean < 0.005


@pytest.mark.parametrize("mode,route,per_forward", [
    ("rdstb", "fused_rdstb", 8), ("pair", "fused_swin_pair", 24)])
@pytest.mark.parametrize("quant", ["qkv", ""], ids=["int8", "bf16"])
def test_bf16_routes_and_stage_designs(mode, route, per_forward, quant):
    """Both bf16 modes build, with or without int8 qkv; every RDSTB's or
    pair's stages take the design ``stage_route`` gives their width:
    the token-parallel stages for int8 qkv and above C = 120, the window
    body for C = 96 with bf16 qkv."""
    model, meta = export.build_serving_model(
        _paras(inference_dtype="bfloat16", pallas_kernels=mode,
               pallas_quant=quant or "off"), device="cpu")
    assert meta["routes"] == [route] * 8
    assert meta["pallas_quant"] == (["qkv"] if quant else None)
    int8 = bool(quant)
    want = ["tokens" if int8 or c > 120 else "window"
            for c in (96, 144, 192)]
    assert rb.dstl_routes(C0, GROWTH, NB, int8) == want
    units = [u for _, u in model.route_units()]
    if mode == "rdstb":
        assert all(u.use_rdstb and u.quant == model.quant for u in units)
        # kernels a call: 5 a token-parallel stage, the pre-norm
        # adapter's 2, 2 a window-body DSTL, the conv
        assert rb.rdstb_kernel_count(want, True) == 1 + sum(
            12 if r == "tokens" else 2 for r in want)
    else:
        layers = [dl.body for u in units for dl in u.body]
        assert len(layers) == per_forward
        assert all(layer.use_pair and layer.quant == model.quant
                   for layer in layers)
        for layer, c in zip(layers, [96, 144, 192] * 8):
            plan = sp.plan_pair_block(
                *layer.blocks[0].fast_kernel_inputs((16, 16), WS, 0),
                num_heads=NH, quant=model.quant)
            assert plan.route == {"tokens": "tokens", "window": "stage"}[
                want[(c - C0) // GROWTH]]
