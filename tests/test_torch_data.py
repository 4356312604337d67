"""The port's data pipeline and metrics against ``rdst_tpu`` on the CPU:

* the synthetic corpus is bitwise the JAX package's for the same seed;
* volume IO round-trips and reads what the JAX package writes;
* the cv2-free cubic resize matches ``rdst_tpu.data.ops.resize`` (cv2
  INTER_CUBIC) within 1e-5 max abs;
* ``sample(rng)`` yields the JAX package's batch for the same generator
  seed (HR crops bitwise, LR inputs within the resize bar);
* the evaluation harness reports the same numbers; FID builds and scores
  as the JAX package's does.
"""

import pathlib

import numpy as np
import pytest

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.data import io as jax_io
from rdst_tpu.data import ops as jax_ops
from rdst_tpu.data import synthetic as jax_synth
from rdst_tpu.data.readers import make_train_valid_datasets as jax_datasets
from rdst_tpu.metrics.evaluation import MetaSREvaluation as JaxEval
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import io, ops, synthetic
from rdst_tpu_torch.data.readers import make_train_valid_datasets
from rdst_tpu_torch.metrics.evaluation import MetaSREvaluation, SRMetrics

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_100k_oasis20_x4.ini")
SHAPE = (40, 48, 24)
RESIZE_TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 3])
def test_phantom_is_bitwise_the_jax_one(seed):
    a = synthetic.brain_phantom(np.random.default_rng(seed), SHAPE)
    b = jax_synth.brain_phantom(np.random.default_rng(seed), SHAPE)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_oasis_tree_is_bitwise_the_jax_one(tmp_path):
    ids = ("OAS1_0001_MR1", "OAS1_0002_MR1")
    synthetic.make_oasis_example(str(tmp_path / "port"), ids, SHAPE, seed=1)
    jax_synth.make_oasis_example(str(tmp_path / "jax"), ids, SHAPE, seed=1)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 8
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


@pytest.mark.parametrize("name", ["v.hdr", "v.nii", "v.nii.gz"])
def test_io_round_trip(tmp_path, name):
    x = np.random.default_rng(0).random((6, 5, 4, 1)).astype(np.float32)
    path = str(tmp_path / name)
    io.save(path, x)
    np.testing.assert_array_equal(io.load(path).get_fdata(), x)
    np.testing.assert_array_equal(jax_io.load(path).get_fdata(), x)
    jax_io.save(path, 2 * x)
    np.testing.assert_array_equal(io.load(path).get_fdata(), 2 * x)


@pytest.mark.parametrize("shape,size", [
    ((96, 96, 1), 24), ((112, 96, 1), (28, 24)), ((24, 24, 1), 96),
    ((37, 53), (11, 17)), ((64, 48, 2), (0.25, 0.25)), ((9, 9, 1), (9, 9)),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cubic_resize_matches_cv2(shape, size, dtype):
    x = np.random.default_rng(1).random(shape).astype(dtype)
    got, want = ops.resize(x, size), jax_ops.resize(x, size)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float(np.abs(got.astype(np.float64) - want).max()) <= RESIZE_TOL


def test_resize_refuses_what_it_cannot_do():
    x = np.zeros((8, 8, 1), np.float32)
    with pytest.raises(NotImplementedError, match="gaussian"):
        ops.resize(x, 4, blur_method="gaussian")
    with pytest.raises(ValueError, match="interpolation"):
        ops.resize(x, 4, interpolation="lanczos")


def _paras(cls, root, **kw):
    p = cls(CONFIG)
    p.set("data_folder", str(root))
    p.set("training_patient_ids_oasis", ["OAS1_0001_MR1", "OAS1_0002_MR1"])
    p.set("validation_patient_ids_oasis", ["OAS1_0003_MR1"])
    p.set("multi_threads", 1)
    p.set("eva_metrics", "psnr ssim")
    for k, v in kw.items():
        p.set(k, v)
    return p


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "OASIS" / "example"
    synthetic.make_oasis_example(
        str(root), ("OAS1_0001_MR1", "OAS1_0002_MR1", "OAS1_0003_MR1"),
        (96, 112, 40))
    return root


def test_sample_matches_jax(corpus):
    tr, va = make_train_valid_datasets(_paras(ParametersLoader, corpus))
    jtr, jva = jax_datasets(_paras(JaxParams, corpus))
    assert len(tr) == len(jtr) and va.test_len() == jva.test_len()
    for seed in (0, 7):
        a = tr.sample(np.random.default_rng(seed))
        b = jtr.sample(np.random.default_rng(seed))
        assert a["in"].shape == b["in"].shape == (32, 24, 24, 1)
        assert a["out"].shape == b["out"].shape == (32, 96, 96, 1)
        np.testing.assert_array_equal(a["out"], b["out"])
        assert float(np.abs(a["in"] - b["in"]).max()) <= RESIZE_TOL
        assert a["sr_factor"] == b["sr_factor"]
    pa, pb = va.get_test_pair(1)[4.0], jva.get_test_pair(1)[4.0]
    np.testing.assert_array_equal(pa["gt"], pb["gt"])
    assert float(np.abs(pa["in"] - pb["in"]).max()) <= RESIZE_TOL


def test_evaluation_matches_jax():
    rng = np.random.default_rng(2)
    gts = [{4.0: {"gt": rng.random((32, 28, 1))}} for _ in range(3)]
    recs = [{4.0: (g[4.0]["gt"] + 0.05 * rng.standard_normal((32, 28, 1))
                   ).astype(np.float32)} for g in gts]
    for mode in ("mean", "full"):
        got = MetaSREvaluation("psnr ssim mse", [4.0], -1, mode)(recs, gts)
        want = JaxEval("psnr ssim mse", [4.0], -1, mode)(recs, gts)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    text = MetaSREvaluation("psnr ssim", [4.0], -1, "mean").print(got)
    assert "psnr" in text.splitlines()[0] and text.count("\n") == 2


def test_fid_raises():
    """FID used to raise here; it now builds and scores: the mean report
    has its one batch-level score, the JAX package's within 1e-4."""
    from rdst_tpu.metrics.evaluation import SRMetrics as JaxSRMetrics

    rng = np.random.default_rng(3)
    gts = rng.random((20, 32, 36, 1), dtype=np.float32)
    preds = np.clip(gts + rng.normal(0, 0.1, gts.shape), 0, 1).astype(
        np.float32)
    got = SRMetrics("psnr fid", -1, "mean")(gts, preds)
    want = JaxSRMetrics("psnr fid", -1, "mean")(gts, preds)
    assert sorted(got) == ["fid", "psnr"]
    assert np.isfinite(got["fid"]) and got["fid"] > 0
    assert abs(got["fid"] - want["fid"]) <= 1e-4 * want["fid"]
