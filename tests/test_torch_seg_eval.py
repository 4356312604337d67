"""The port's segmentation evaluation (``rdst_tpu_torch.runners.seg_eval``)
and the numbers behind its figures (``rdst_tpu_torch.utils.figures``)
against ``rdst_tpu``'s on the CPU, with the committed ``SegUNet(1, 4)``
(``weights/unet_tiny.pkl``):

* a saved SR volume (the tester's ``{pid}_inference_results.npz``, here
  written from the GT plus seeded noise, no tester run) through both
  packages' ``seg_eval``: the UNet's logits within 1e-4, the labels
  equal, the per-class Dice within 1e-6, the same table rows;
* the figure data: per-slice PSNR and Dice as the JAX figure script
  computes them (1e-6); the training-record series of a trainer's output;
* ``seg_eval``'s entry point refuses to run without a card unless
  ``--gpu-id -1`` asks for the CPU.
"""

import json
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.metrics.image_metrics import psnr as jax_psnr
from rdst_tpu.models.seg_unet import SegUNet as JaxSegUNet
from rdst_tpu.runners.seg_eval import seg_eval as jax_seg_eval
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.data.readers import make_test_dataset
from rdst_tpu_torch.runners import seg_eval as port
from rdst_tpu_torch.utils import figures

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
UNET = str(REPO / "weights" / "unet_tiny.pkl")
PID = "OAS1_0004_MR1"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A four-phantom corpus (seed 0) and, for its testing patient, an SR
    volume: the GT slices plus noise of std 0.05 from a seeded numpy
    generator, saved where the tester saves it."""
    root = tmp_path_factory.mktemp("segeval")
    data = root / "OASIS" / "example"
    synthetic.make_oasis_example(str(data), shape=(40, 48, 24))
    over = {"data_folder": str(data), "output_dir": str(root / "out"),
            "verbose": False}
    tp = ParametersLoader(CONFIG)
    jp = JaxParams(CONFIG)
    for p in (tp, jp):
        for k, v in over.items():
            p.set(k, v)
    ds = make_test_dataset(tp, [PID])
    gts = np.stack([ds.get_test_pair(i)[4.0]["gt"]
                    for i in range(ds.test_len())])
    rng = np.random.default_rng(7)
    sr = (gts + 0.05 * rng.standard_normal(gts.shape)).astype(np.float32)
    inf = (root / "out" / "RDST_TINY_OASIS_SRx4_None_Final_Predictions"
           / "inference_results")
    inf.mkdir(parents=True)
    np.savez_compressed(inf / f"{PID}_inference_results.npz", **{"x4.0": sr})
    with open(UNET, "rb") as f:
        variables = pickle.load(f)
    return {"tp": tp, "jp": jp, "sr": sr, "gts": gts,
            "variables": variables}


@pytest.fixture(scope="module")
def jax_logits(setup):
    """The JAX UNet's logits (NHWC) of the SR volume and the GT."""
    unet = JaxSegUNet(in_channels=1, classes=4)
    fn = jax.jit(lambda x: unet.apply(setup["variables"], x, train=False)[2])
    return {k: np.asarray(fn(jnp.asarray(setup[k]))) for k in ("sr", "gts")}


def test_unet_logits_and_labels_match_jax(setup, jax_logits):
    unet = port.load_unet(setup["variables"], 1, "cpu")
    for k in ("sr", "gts"):
        got = port.unet_logits(unet, setup[k]).numpy().transpose(0, 2, 3, 1)
        want = jax_logits[k]
        assert float(np.abs(got - want).max()) <= 1e-4 * max(
            1.0, float(np.abs(want).max()))
        np.testing.assert_array_equal(port.segment(unet, setup[k]),
                                      want.argmax(-1))


def test_seg_eval_matches_jax(setup):
    want, want_table = jax_seg_eval(setup["jp"], UNET, verbose=False)
    got, table = port.seg_eval(setup["tp"], UNET, verbose=False,
                               device="cpu")
    assert got.shape == want.shape == (1, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rows = [line.split() for line in table.splitlines()]
    want_rows = [line.split() for line in want_table.splitlines()]
    assert rows[0] == want_rows[0] == ["patient", "class0", "class1",
                                       "class2", "class3"]
    # per patient and MEAN (tabulate prints '1.0000' as '1')
    assert [r[0] for r in rows[2:]] == [r[0] for r in want_rows[2:]]
    np.testing.assert_array_equal(
        [[float(v) for v in r[1:]] for r in rows[2:]],
        [[float(v) for v in r[1:]] for r in want_rows[2:]])
    assert rows[-1][0] == "MEAN"


def test_figure_data_matches_the_jax_figures(setup, jax_logits):
    from rdst_tpu.metrics.image_metrics import dice_coefficient

    ids = [0, 5]
    rows = figures.patient_figure_data(setup["tp"], PID, ids,
                                       unet_ckpt=UNET, device="cpu")
    for i, row in zip(ids, rows):
        gt, sr = setup["gts"][i], setup["sr"][i]
        np.testing.assert_array_equal(row["SR"], sr)
        assert abs(row["psnr"]["SR"] - jax_psnr(gt, sr)) <= 1e-6
        want = dice_coefficient(jax_logits["gts"][i].argmax(-1),
                                jax_logits["sr"][i].argmax(-1))
        np.testing.assert_allclose(row["dice"], want, rtol=0, atol=1e-6)
        assert row["Bicubic"].shape == gt.shape == row["GT"].shape


def test_training_record_series(tmp_path):
    root = tmp_path / "run"
    (root / "final_results").mkdir(parents=True)
    (root / "checkpoint").mkdir()
    np.save(root / "final_results" / "training_records.npy",
            np.asarray({"training_loss_records": {"WarmUP": [0.3, 0.2]},
                        "training_epoch_costs": [1.0, 1.0]}, dtype=object))
    with open(root / "checkpoint" / "host_state.json", "w") as f:
        json.dump({"loss_records": {"records": {
            "WarmUP": {"L1": [0.3, 0.2]}, "GAN": {}}}}, f)
    s = figures.training_record_series(str(root))
    np.testing.assert_array_equal(s["loss"]["WarmUP"], [0.3, 0.2])
    assert list(s["components"]) == ["WarmUP"]
    np.testing.assert_array_equal(s["components"]["WarmUP"]["L1"],
                                  [0.3, 0.2])


def test_entry_point_needs_a_card_or_gpu_id(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks a machine without one")
    cfg = tmp_path / "c.ini"
    cfg.write_text(pathlib.Path(CONFIG).read_text())
    with pytest.raises(RuntimeError, match="cuda"):
        port.main(["--config-file", str(cfg), "--unet", UNET])


def test_drawing_functions_write_pngs(setup, tmp_path):
    """Where matplotlib is installed (the card's machine has none) the
    two drawing functions write their PNGs from the same numbers."""
    pytest.importorskip("matplotlib")
    paths = figures.render_patient_figures(
        setup["tp"], PID, [3], zoom=(8, 8, 16, 16), unet_ckpt=UNET,
        out_dir=str(tmp_path / "fig"), device="cpu")
    assert [pathlib.Path(p).name for p in paths] == [f"{PID}_slice3_x4.0.png"]
    root = tmp_path / "run"
    (root / "final_results").mkdir(parents=True)
    np.save(root / "final_results" / "training_records.npy",
            np.asarray({"training_loss_records": {"WarmUP": [0.3, 0.2]}},
                       dtype=object))
    written = figures.plot_training_records(str(root))
    assert [pathlib.Path(p).name for p in written] == ["replot_WarmUP_loss.png"]
    assert all(pathlib.Path(p).stat().st_size > 0 for p in paths + written)
