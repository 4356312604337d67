"""MetaSR in the port (``rdst_tpu_torch.models.{meta_upscale,edsr,metasr}``)
against the JAX package on the CPU:

* ``meta_upscale_plan`` equals the JAX function's three arrays, bitwise,
  for LR sizes odd and even at scales 1.5 - 4;
* ``MetaUpSampler`` (C = 16) equals flax within 1e-5 at those scales, the
  output and every parameter gradient, with the parameters carried over
  by the port's converter;
* EDSR (2 blocks, 16 features) equals flax within 1e-4 in its three
  forms: the PixelShuffle tail, the scale-free ``tail_meta``, and the
  feature maps MetaSR extracts;
* MetaSR with the committed ``weights/metasr_20k_best_oasis20_x4.msgpack``
  (72 leaves, 1,368,320 parameters) equals flax within 1e-4 on a seeded
  40x32 slice at 1.5 and 4, and its weights go back to flax unchanged;
* the tester at [1.5, 2, 3, 4] on a small seeded corpus, with
  ``residual_scale`` 0 and 0.5, scores as the JAX tester does;
* ``LiveModel.predict(x, 1.5)`` equals the model called at 1.5 (an LR
  that is 37x29) and refuses a scale it does not serve; a scale-free
  model called without a scale raises;
* all of it imports and serves with jax, flax, msgpack and ``rdst_tpu``
  unimportable.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.data.readers import make_test_dataset as jax_test_dataset
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.models import meta_upscale as jmu
from rdst_tpu.runners.tester import SRTester as JaxTester
from rdst_tpu_torch.checkpoint.convert import export_named, import_named
from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
from rdst_tpu_torch.checkpoint.msgpack_reader import flatten, read_snapshot
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.data.readers import make_test_dataset
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models import meta_upscale as tmu
from rdst_tpu_torch.runners.tester import SRTester
from rdst_tpu_torch.serving import export

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "metasr_20k_oasis20_x4.ini")
WEIGHTS = str(REPO / "weights" / "metasr_20k_best_oasis20_x4.msgpack")
SCALES = [1.5, 2.0, 2.5, 3.0, 3.5, 4.0]
SIZES = [(40, 32), (37, 29), (24, 24), (16, 12), (13, 7), (1, 5)]
SMALL = {"edsr_n_resblocks": 2, "edsr_n_feats": 16}
TEST_SCALES = [1.5, 2.0, 3.0, 4.0]
PID = "OAS1_0004_MR1"


def _paras(cls, **kw):
    p = cls(CONFIG)
    for k, v in kw.items():
        p.set(k, v)
    return p


def _load(model, sd):
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model


@pytest.mark.parametrize("scale", SCALES)
def test_plan_matches_jax(scale):
    for h, w in SIZES:
        got = tmu.meta_upscale_plan(h, w, scale)
        want = jmu.meta_upscale_plan(h, w, scale)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b), (h, w, scale)
        assert len(got[2]) == int(scale * h) * int(scale * w)


@pytest.mark.parametrize("scale", SCALES)
def test_meta_upsampler_matches_flax(scale):
    """Forward and parameter gradients of a C = 16 upsampler on an odd
    LR (13x11), seeded cotangent, within 1e-5 of each leaf's size."""
    rng = np.random.default_rng(int(scale * 10))
    x = rng.normal(size=(2, 13, 11, 16)).astype(np.float32)
    jm = jmu.MetaUpSampler(out_c=1)
    params = jax.jit(lambda k, v: jm.init(k, v, scale))(
        jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params)
    oh, ow = int(scale * 13), int(scale * 11)
    cot = rng.normal(size=(2, oh, ow, 1)).astype(np.float32)

    def f(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), scale) * cot)

    want = np.asarray(jm.apply(params, jnp.asarray(x), scale))
    jg = export_named(jax.tree.map(np.asarray, jax.grad(f)(params)))
    tm = _load(tmu.MetaUpSampler(16, 1), export_named(params))
    got = tm(torch.from_numpy(x), scale)
    assert got.shape == want.shape == (2, oh, ow, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (got * torch.from_numpy(cot)).sum().backward()
    assert sorted(jg) == sorted(n for n, _ in tm.named_parameters())
    for n, p in tm.named_parameters():
        ref = jg[n]
        assert np.abs(p.grad.numpy() - ref).max() <= 1e-5 * max(
            np.abs(ref).max(), 1e-30), n


@pytest.mark.parametrize("form,scale", [("fixed", 4.0), ("fixed", 3.0),
                                        ("scale_free", 1.5),
                                        ("scale_free", 3.5),
                                        ("features", None)])
def test_edsr_matches_flax(form, scale):
    from rdst_tpu.models.edsr import make_edsr as jax_edsr
    from rdst_tpu_torch.models.edsr import make_edsr

    kw = dict(SMALL, feature_generator="edsr", leaky_relu_slope=0.1,
              scale_free=form == "scale_free",
              sr_scale=scale if form == "fixed" else 4.0)
    jp, tp = _paras(JaxParams, **kw), _paras(ParametersLoader, **kw)
    jm = jax_edsr(jp)
    if form == "features":
        jm = jm.clone(feature_maps_only=True)
    tm = make_edsr(tp, feature_maps_only=form == "features")
    assert tm.kernel_mode == "" and tm.routes == []
    x = np.random.default_rng(3).random((2, 13, 10, 1), dtype=np.float32)
    params = jax.jit(lambda k, v: jm.init(k, v, scale))(
        jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params)
    want = np.asarray(jm.apply(params, jnp.asarray(x), scale))
    _load(tm, export_named(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    back = import_named(tm.state_dict())
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def committed():
    """The shipped config's JAX model and the committed weights, and the
    port's MetaSR loaded from them."""
    jp = JaxParams(CONFIG)
    jm = jax_build(jp)
    x0 = jnp.zeros((1, 40, 32, 1), jnp.float32)
    tmpl = jax.jit(lambda k, v: jm.init(k, v, 1.5))(jax.random.PRNGKey(0), x0)
    with open(WEIGHTS, "rb") as f:
        params = serialization.from_bytes(tmpl, f.read())
    tp = ParametersLoader(CONFIG)
    tm = load_well_trained_params(build_generator(tp), tp, WEIGHTS, [])
    return jm, params, tm


def test_committed_snapshot_loads_and_writes_back(committed):
    _, params, tm = committed
    flat = flatten(read_snapshot(WEIGHTS))
    assert len(flat) == 72
    assert sum(v.size for v in flat.values()) == 1368320
    assert sum(p.numel() for p in tm.parameters()) == 1368320
    sd = tm.state_dict()
    assert sd["meta_upsampler.P2W.fc1.weight"].shape == (256, 3)
    assert sd["meta_upsampler.P2W.fc2.weight"].shape == (576, 256)
    assert sd["extractor.body_15.conv_1.weight"].shape == (64, 64, 3, 3)
    back = import_named(sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray,
                                                         params)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("scale", [1.5, 4.0])
def test_committed_metasr_matches_flax(committed, scale):
    jm, params, tm = committed
    x = np.random.default_rng(0).random((1, 40, 32, 1), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, scale))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape == (1, int(40 * scale), int(32 * scale), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_scale_free_model_needs_a_scale(committed):
    _, _, tm = committed
    with pytest.raises(ValueError, match="sr_scale"):
        tm(torch.zeros(1, 8, 8, 1))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("metasr") / "OASIS" / "example20"
    synthetic.make_oasis_example(str(data), shape=(96, 112, 10))
    return data


def _tester_paras(cls, corpus, out):
    return _paras(cls, data_folder=str(corpus), output_dir=str(out),
                  well_trained_model_metasr=WEIGHTS, verbose=False,
                  testing_patient_ids_oasis=[PID])


@pytest.mark.parametrize("residual_scale", [0.0, 0.5])
def test_tester_matches_jax(corpus, tmp_path, residual_scale):
    """The committed MetaSR through both testers at [1.5, 2, 3, 4]: the
    outputs within 1e-4, the per-slice PSNR within 1e-3 dB and SSIM
    within 1e-5 (``test_torch_tester.py``'s bars)."""
    jt = JaxTester(_tester_paras(JaxParams, corpus, tmp_path / "j"))
    pt = SRTester(_tester_paras(ParametersLoader, corpus, tmp_path / "p"),
                  device="cpu")
    for t in (jt, pt):
        t.setup()
        t.residual_scale = residual_scale
    assert pt.sr_scales == TEST_SCALES and pt.manifest["scale_free"]
    jr, jpairs = jt.inference_patient(jax_test_dataset(jt.paras, [PID]))
    pr, ppairs = pt.inference_patient(make_test_dataset(pt.paras, [PID]))
    for s in TEST_SCALES:
        got = np.stack([r[s] for r in pr])
        want = np.stack([r[s] for r in jr])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jrep, prep = jt.eva_func(jr, jpairs), pt.eva_func(pr, ppairs)
    for s in TEST_SCALES:
        np.testing.assert_allclose(prep[f"psnr_{s}"], jrep[f"psnr_{s}"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(prep[f"ssim_{s}"], jrep[f"ssim_{s}"],
                                   rtol=0, atol=1e-5)


def test_live_model_serves_fractional_scales():
    p = _paras(ParametersLoader, well_trained_model_metasr=WEIGHTS)
    live = export.LiveModel(p, max_batch=4, device="cpu")
    assert live.manifest["scales"] == TEST_SCALES
    assert live.manifest["pallas_kernels"] is None
    assert live.manifest["routes"] == []
    x = np.random.default_rng(5).random((3, 37, 29), dtype=np.float32)
    got = live.predict(x, 1.5)
    with torch.no_grad():
        want = live.model(torch.from_numpy(x[..., None]), 1.5).numpy()
    assert got.shape == (3, 55, 43, 1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not served"):
        live.predict(x, 2.5)


def test_serves_without_jax():
    """The MetaSR modules import, load the committed weights and serve
    at 1.5 with jax, flax, msgpack and rdst_tpu unimportable."""
    script = f"""
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "rdst_tpu"):
    sys.modules[name] = None
import numpy as np
import rdst_tpu_torch.models.edsr, rdst_tpu_torch.models.meta_upscale
import rdst_tpu_torch.models.metasr
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.serving.export import LiveModel
p = ParametersLoader({CONFIG!r})
p.set("well_trained_model_metasr", {WEIGHTS!r})
live = LiveModel(p, max_batch=2, device="cpu")
y = live.predict(np.random.default_rng(0).random((2, 20, 16), dtype=np.float32), 1.5)
assert y.shape == (2, 30, 24, 1) and np.isfinite(y).all(), y.shape
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "msgpack", "rdst_tpu")
                and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
