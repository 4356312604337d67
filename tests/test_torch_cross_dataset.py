"""The port's tester on the cross-dataset layouts (BraTS's four
modalities as channels, ACDC's frame globs and 128 crop, COVID-CT's 512
crop and whole-slice inference) against the JAX tester on the CPU.

Each shipped ``rdst_e1_10k_{brats8,acdc8,covid8}_x4.ini`` with a small
RDST (embed 12, window 4) and one set of seeded random weights, written
as a flax snapshot that both packages load (the port through
``checkpoint.convert``), scores its testing patient on a corpus cut in
depth (BraTS and ACDC to a few slices; COVID keeps its 630x630 slices
and so its 512 crop, LR 128x128): per-modality (BraTS) or per-slice
PSNR / SSIM within 1e-4 of the JAX tester's, the saved SR volumes within
1e-4. The port's generator writes the JAX generator's volumes for the
testing patient (``only`` keeps the patient's own seed), bitwise.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.data import synthetic as jax_synthetic
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.runners.tester import SRTester as JaxTester
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import io, synthetic
from rdst_tpu_torch.runners.tester import SRTester

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [2, 2], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [1, 1],
         "patch_size": 8}
# name: (config, maker, id format, volume shape cut in depth, channels)
DATASETS = {
    "BraTS": ("rdst_e1_10k_brats8_x4.ini", "make_brats_example",
              "HGG_Brats17_SYN_{:03d}_1", (80, 96, 6), 4),
    "ACDC": ("rdst_e1_10k_acdc8_x4.ini", "make_acdc_example",
             "patient{:03d}", (160, 160, 3), 1),
    "COVID": ("rdst_e1_10k_covid8_x4.ini", "make_covid_example",
              "volume-covid19-A-{:04d}", (630, 630, 3), 1),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(fmt):
    return tuple(fmt.format(i) for i in range(1, 9))


def _files(root):
    return sorted(p for p in pathlib.Path(root).rglob("*.nii.gz"))


@pytest.fixture(scope="module", params=list(DATASETS))
def scored(request, tmp_path_factory):
    name = request.param
    config, maker, fmt, shape, channels = DATASETS[name]
    root = tmp_path_factory.mktemp(name.lower())
    data = root / name / "example8"
    pid = fmt.format(8)
    getattr(synthetic, maker)(str(data), patient_ids=_ids(fmt), shape=shape,
                              only=(pid,))
    # the JAX generator writes every patient; its testing patient's
    # volumes are the port's, bitwise
    ref = root / "jax" / name / "example8"
    getattr(jax_synthetic, maker)(str(ref), patient_ids=_ids(fmt),
                                  shape=shape)
    ours = _files(data)
    assert ours and all(pid.split("_")[0] in str(f) or pid in str(f)
                        for f in ours)
    for f in ours:
        np.testing.assert_array_equal(
            io.load(str(f)).get_fdata(),
            io.load(str(ref / f.relative_to(data))).get_fdata())

    over = {**SMALL, "data_folder": str(data), "verbose": False,
            "multi_threads": 1}
    jp, tp = JaxParams(str(REPO / "config_files" / config)), \
        ParametersLoader(str(REPO / "config_files" / config))
    for p in (jp, tp):
        for k, v in over.items():
            p.set(k, v)
    assert int(tp.input_channel) == channels
    variables = jax.jit(jax_build(jp).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 8, 8, channels), jnp.float32))
    snap = root / "random.msgpack"
    snap.write_bytes(serialization.to_bytes(variables))
    out = {}
    for key, cls, p, kw in (("jax", JaxTester, jp, {}),
                            ("port", SRTester, tp, {"device": "cpu"})):
        p.set("output_dir", str(root / key))
        p.set("well_trained_single_scale_model_g", str(snap))
        tester = cls(p, **kw)
        tester.setup()
        stacked = tester.test()
        with np.load(pathlib.Path(tester.dirs["inference_results"])
                     / f"{pid}_inference_results.npz") as z:
            out[key] = (stacked, z["x4.0"])
    return name, out


def test_cross_dataset_tester_matches_jax(scored):
    name, out = scored
    (want, want_sr), (got, sr) = out["jax"], out["port"]
    assert sr.shape == want_sr.shape
    assert float(np.abs(sr - want_sr).max()) <= 1e-4
    if name == "BraTS":  # one report a modality, in the config's order
        assert list(got) == list(want) == ["t1ce", "t1", "t2", "flair"]
        pairs = [(got[m], want[m]) for m in want]
        assert sr.shape[-1] == 4
    else:
        pairs = [(got, want)]
    if name == "COVID":  # the 512 crop: LR 128x128 -> HR 512x512
        assert sr.shape[1:] == (512, 512, 1)
    if name == "ACDC":  # the 128 crop
        assert sr.shape[1:] == (128, 128, 1)
    for g, w in pairs:
        assert sorted(g) == sorted(w) == ["psnr_4.0", "ssim_4.0"]
        for k in w:
            assert len(g[k]) == len(w[k]) > 0
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4)
