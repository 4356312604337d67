"""The port's tester (``rdst_tpu_torch.runners.tester``, ``python -m
rdst_tpu_torch.test``) against the JAX tester on the CPU.

The committed tiny snapshot (``weights/rdst_tiny2k_oasis_x4.msgpack``,
``config_files/rdst_tiny_oasis_x4.ini``) scores one patient of a small
phantom corpus made from seed 0, through both packages:

* whole-slice: per-slice PSNR within 1e-3 dB and SSIM within 1e-5, the
  saved volumes within 1e-4, the same artifact names; a second run, and
  a run after the JAX tester, take the cached reports;
* bicubic mode: the images within the resize bar of
  ``test_torch_data.py`` (1e-5), the scores within the bars above;
* tiled inference: the tiled outputs within 1e-4 of the JAX tester's,
  and within 2 dB of whole-slice SR;
* ``residual_scale = 0.5``: within 1e-5 of the JAX tester;
* the golden gate: the tiny snapshot scores >= 27.5 dB on fresh
  phantoms through ``test_main(['--gpu-id', '-1', ...])``;
* the tester runs with jax, flax, msgpack and rdst_tpu blocked, and
  ``test_main`` without ``--gpu-id -1`` raises where there is no card.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.data.readers import make_test_dataset as jax_test_dataset
from rdst_tpu.runners.tester import SRTester as JaxTester
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.data.readers import make_test_dataset
from rdst_tpu_torch.runners.tester import SRTester

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "config_files" / "rdst_tiny_oasis_x4.ini"
WEIGHTS = REPO / "weights" / "rdst_tiny2k_oasis_x4.msgpack"
PID = "OAS1_0004_MR1"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four phantoms of 64x80x40 (25 test slices of LR 18x14 -> HR
    72x56), seed 0."""
    data = tmp_path_factory.mktemp("tester") / "OASIS" / "example"
    synthetic.make_oasis_example(str(data), shape=(64, 80, 40))
    return data


def _overrides(corpus, out, **kw):
    d = {"data_folder": str(corpus), "output_dir": str(out),
         "well_trained_single_scale_model_g": str(WEIGHTS), "verbose": False}
    d.update(kw)
    return d


def _paras(cls, corpus, out, **kw):
    p = cls(str(CONFIG))
    for k, v in _overrides(corpus, out, **kw).items():
        p.set(k, v)
    return p


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*"))


@pytest.fixture(scope="module")
def jax_tester(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_out")
    t = JaxTester(_paras(JaxParams, corpus, out))
    t.setup()
    return t, t.test()


@pytest.fixture(scope="module")
def port_tester(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_out")
    t = SRTester(_paras(ParametersLoader, corpus, out), device="cpu")
    t.setup()
    return t, t.test()


def test_whole_slice_matches_jax(jax_tester, port_tester):
    (jt, jst), (pt, pst) = jax_tester, port_tester
    assert len(pst["psnr_4.0"]) == len(jst["psnr_4.0"]) == 25
    np.testing.assert_allclose(pst["psnr_4.0"], jst["psnr_4.0"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(pst["ssim_4.0"], jst["ssim_4.0"], rtol=0,
                               atol=1e-5)
    name = f"{PID}_inference_results.npz"
    got = np.load(os.path.join(pt.dirs["inference_results"], name))["x4.0"]
    want = np.load(os.path.join(jt.dirs["inference_results"], name))["x4.0"]
    assert got.shape == want.shape == (25, 72, 56, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert _tree(pt.output_root) == _tree(jt.output_root)
    assert os.path.basename(pt.output_root) == \
        "RDST_TINY_OASIS_SRx4_None_Final_Predictions"


def test_cached_reports_are_reused(corpus, jax_tester, port_tester):
    """A second port run, and a port run over the JAX tester's output,
    read the saved reports instead of running the model."""
    (jt, jst), (pt, pst) = jax_tester, port_tester
    for root, want in ((pt.paras.output_dir, pst), (jt.paras.output_dir, jst)):
        t = SRTester(_paras(ParametersLoader, corpus, root), device="cpu")
        t.setup()
        t.inference_patient = None  # a cached run never reaches the model
        got = t.test()
        assert got == want
        with open(t.log_file) as f:
            assert f"{PID}: cached report found" in f.read()


def test_bicubic_matches_jax(corpus, tmp_path):
    kw = {"feature_generator": "bicubic", "model_name": "BIC"}
    jt = JaxTester(_paras(JaxParams, corpus, tmp_path / "j", **kw))
    jt.setup()
    pt = SRTester(_paras(ParametersLoader, corpus, tmp_path / "p", **kw),
                  device="cpu")
    pt.setup()
    jr, _ = jt.inference_patient(jax_test_dataset(jt.paras, [PID]))
    pr, _ = pt.inference_patient(make_test_dataset(pt.paras, [PID]))
    # RESIZE_TOL of test_torch_data.py: the JAX package resizes with its
    # host-compiled float32 C++ kernel, whose last bit follows the
    # compiler's contractions; the port's cubic is the float64 form
    np.testing.assert_allclose(np.stack([r[4.0] for r in pr]),
                               np.stack([r[4.0] for r in jr]), rtol=0,
                               atol=1e-5)
    jst, pst = jt.test(), pt.test()
    np.testing.assert_allclose(pst["psnr_4.0"], jst["psnr_4.0"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(pst["ssim_4.0"], jst["ssim_4.0"], rtol=0,
                               atol=1e-5)


def _recs(tester, ds):
    recs, pairs = tester.inference_patient(ds)
    return np.stack([r[4.0] for r in recs]), pairs


def test_tiled_inference_matches_jax(jax_tester, port_tester):
    """Patch 16, stride 8 (overlapping tiles, a padded grid) against the
    JAX tester's tiled output, and every slice within 2 dB of whole-slice
    SR."""
    from rdst_tpu_torch.metrics.image_metrics import psnr

    (jt, _), (pt, _) = jax_tester, port_tester
    ds = make_test_dataset(pt.paras, [PID])
    whole, pairs = _recs(pt, ds)
    for t in (jt, pt):
        t.paras.set("patch_size", 16)
        t.paras.set("test_lr_patch_stride", 8)
        t.paras.set("tiled_inference", True)
    try:
        want, _ = _recs(jt, jax_test_dataset(jt.paras, [PID]))
        got, _ = _recs(pt, ds)
    finally:
        for t in (jt, pt):
            t.paras.set("tiled_inference", False)
    assert got.shape == whole.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for i in range(len(pairs)):
        gt = pairs[i][4.0]["gt"]
        d = psnr(gt, np.clip(got[i], 0, 1)) - psnr(gt, np.clip(whole[i], 0, 1))
        assert abs(d) < 2.0, (i, d)


def test_residual_blend_matches_jax(jax_tester, port_tester):
    (jt, _), (pt, _) = jax_tester, port_tester
    jt.residual_scale = pt.residual_scale = 0.5
    try:
        want, _ = _recs(jt, jax_test_dataset(jt.paras, [PID]))
        got, _ = _recs(pt, make_test_dataset(pt.paras, [PID]))
    finally:
        jt.residual_scale = pt.residual_scale = 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_golden_quality_through_test_main(tmp_path):
    """The committed 2000-step tiny snapshot scores >= 27.5 dB on fresh
    phantoms (bicubic ~25.8 dB), through the CLI on the CPU."""
    from rdst_tpu_torch.cli import test_main

    data = tmp_path / "OASIS" / "example"
    synthetic.make_oasis_example(str(data), shape=(96, 112, 96))
    over = _overrides(data, tmp_path / "out", model_name="GOLDEN")
    tester = test_main(["--gpu-id", "-1", "--config-file", str(CONFIG)]
                       + [f"{k}={v!r}" for k, v in over.items()])
    assert tester.device.type == "cpu"
    stacked = np.load(os.path.join(tester.output_root,
                                   "stacked_eva_reports.npy"),
                      allow_pickle=True).item()
    mean_psnr = float(np.mean(stacked["psnr_4.0"]))
    assert mean_psnr >= 27.5, mean_psnr


def test_fid_in_eva_metrics_does_not_stop_the_tester(corpus):
    """The shipped configs list ``fid`` in ``eva_metrics``: the test
    dataset builds that report on first use (the tester itself scores
    ``eva_metrics_for_testing``), and it scores FID with the rest."""
    p = _paras(ParametersLoader, corpus, "unused", eva_metrics="psnr ssim fid")
    p.set("eva_gpu_id", -1)
    ds = make_test_dataset(p, [PID])
    assert ds.test_len() == 25
    eva = ds.get_final_eva_func()
    pairs = [ds.get_test_pair(i) for i in range(4)]
    recs = [{4.0: pair[4.0]["gt"]} for pair in pairs]
    report = eva(recs, pairs)
    assert report["fid_4.0"] == [pytest.approx(0.0, abs=1e-6)]
    assert len(report["psnr_4.0"]) == 4


def test_test_main_without_a_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks a machine without one")
    from rdst_tpu_torch.cli import test_main

    over = _overrides(corpus, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        test_main(["--config-file", str(CONFIG)]
                  + [f"{k}={v!r}" for k, v in over.items()])
    assert not (tmp_path / "RDST_TINY_OASIS_SRx4_None_Final_Predictions").exists()


def test_tester_runs_without_jax(corpus, tmp_path):
    """The tester, with lpips and vifp among its metrics, and the volume
    CLI run with jax, flax, msgpack and rdst_tpu unimportable."""
    over = _overrides(corpus, tmp_path / "out",
                      eva_metrics_for_testing="psnr ssim vifp lpips",
                      testing_patient_ids_oasis=["OAS1_0003_MR1"])
    ini = tmp_path / "tiny.ini"
    ini.write_text(CONFIG.read_text().replace(
        "./outputs/RDST_TINY_OASIS_SRx4_None/models/WarmUP_model_g.msgpack",
        str(WEIGHTS)))
    script = f"""
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "rdst_tpu"):
    sys.modules[name] = None
import numpy as np
from rdst_tpu_torch.cli import test_main
from rdst_tpu_torch.data import io
from rdst_tpu_torch.serving import volume
over = {over!r}
t = test_main(["--gpu-id", "-1", "--config-file", {str(CONFIG)!r}]
              + [f"{{k}}={{v!r}}" for k, v in over.items()])
st = np.load(t.output_root + "/stacked_eva_reports.npy", allow_pickle=True).item()
assert sorted(st) == ["lpips_4.0", "psnr_4.0", "ssim_4.0", "vifp_4.0"], st
assert len(st["lpips_4.0"]) == len(st["psnr_4.0"]) > 0
assert np.isfinite(st["lpips_4.0"]).all() and min(st["lpips_4.0"]) > 0
vol = np.random.default_rng(0).random((12, 10, 3), dtype=np.float32)
io.save({str(tmp_path / "v.nii")!r}, vol)
volume.main(["--config-file", {str(ini)!r}, "--platform", "cpu",
             "--in", {str(tmp_path / "v.nii")!r},
             "--out", {str(tmp_path / "v4.nii")!r}])
out = io.load({str(tmp_path / "v4.nii")!r}).get_fdata()
assert out.shape == (48, 40, 3), out.shape
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "msgpack", "rdst_tpu")
                and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
