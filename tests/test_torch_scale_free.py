"""Scale-free models in the port against the JAX package on the CPU:

* a scale-free ``rdst_tiny_oasis_x4.ini`` (the MetaUpSampler tail after
  the RDST body; f32 on the kernels' plain versions) equals flax within
  1e-4 at 1.5 and 4, on a 40x32 LR and on a 37x29 LR that the model pads
  to whole windows and crops to ``int(orig * s)``, through
  ``LiveModel``;
* one bf16 training step of a reduced scale-free RDST at a real scale
  of 1.5, through the train-pair route (the port's plain version, the
  JAX kernel in interpret mode), matches the JAX step: loss within 2e-2,
  each gradient within 0.08 of the largest (``test_torch_train.py``'s
  bars, the convolutions' bias gradients held against the JAX f32 step);
* a 3-step MetaSR training run (EDSR of 2 blocks, 16 features, batch 8,
  scales drawn from ``all_sr_scales``) records the JAX trainer's losses
  within 1e-4 relative and its final evaluation's scores, with
  ``residual_scale`` 0 and 0.5, from the same warm start.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.data.readers import make_train_valid_datasets as jax_datasets
from rdst_tpu.losses.sr_loss import SRLoss as JaxLoss
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.runners.trainer import TransSRTrainer as JaxTrainer
from rdst_tpu.serving import export as jax_export
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.checkpoint.msgpack_writer import write_snapshot
from rdst_tpu_torch.cli import build_trainer
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.losses.sr_loss import SRLoss
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import set_train_mode
from rdst_tpu_torch.serving import export

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
METASR = str(REPO / "config_files" / "metasr_20k_oasis20_x4.ini")
SCALE_FREE = {"scale_free": True, "all_sr_scales": [1.5, 2.0, 2.5, 3.0, 3.5,
                                                    4.0],
              "test_sr_scales": [1.5, 4.0],
              "sr_scales_for_final_testing": [1.5, 4.0]}
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [2, 2], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [2, 2],
         "patch_size": 8}


def _paras(cls, config, **kw):
    p = cls(config)
    for k, v in kw.items():
        p.set(k, v)
    return p


@pytest.fixture(scope="module")
def tiny_snapshot(tmp_path_factory):
    """A scale-free tiny RDST's flax init, written as a snapshot."""
    jp = _paras(JaxParams, TINY, **SCALE_FREE)
    jm = jax_build(jp)
    x0 = jnp.zeros((1, 40, 32, 1), jnp.float32)
    params = jax.jit(lambda k, v: jm.init(k, v, 1.5))(jax.random.PRNGKey(4),
                                                      x0)
    params = jax.tree.map(np.asarray, params)
    tm = build_generator(_paras(ParametersLoader, TINY, **SCALE_FREE))
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        export_rdstsr(params, tm.mean, tm.std).items()})
    path = tmp_path_factory.mktemp("sf") / "tiny_sf.msgpack"
    write_snapshot(str(path), tm.state_dict())
    return str(path)


@pytest.fixture(scope="module")
def lives(tiny_snapshot):
    kw = dict(SCALE_FREE, well_trained_single_scale_model_g=tiny_snapshot)
    return (jax_export.LiveModel(_paras(JaxParams, TINY, **kw), max_batch=2),
            export.LiveModel(_paras(ParametersLoader, TINY, **kw),
                             max_batch=2, device="cpu"))


@pytest.mark.parametrize("hw", [(40, 32), (37, 29)])
@pytest.mark.parametrize("scale", [1.5, 4.0])
def test_scale_free_rdst_matches_flax(lives, hw, scale):
    jlive, live = lives
    assert live.manifest["scales"] == [1.5, 4.0]
    assert live.manifest["routes"] == ["fused_swin_block"] * 2
    x = np.random.default_rng(hw[0]).random((2,) + hw, dtype=np.float32)
    want = jlive.predict(x, scale)
    got = live.predict(x, scale)
    assert got.shape == want.shape == (2, int(hw[0] * scale),
                                       int(hw[1] * scale), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_scale_free_rdst_refuses_no_scale(lives):
    _, live = lives
    with pytest.raises(ValueError, match="sr_scale"):
        live.model(torch.zeros(1, 8, 8, 1))


def _jax_step(jp, jm, params, batch, scale):
    loss = JaxLoss(jp)

    def f(p):
        pred = jm.apply(p, jnp.asarray(batch["in"]), scale,
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "droppath": jax.random.PRNGKey(2)})
        return loss(pred.astype(jnp.float32),
                    {"out": jnp.asarray(batch["out"])}, "WarmUP")[0]

    v, g = jax.value_and_grad(f)(params)
    return float(v), jax.tree.map(np.asarray, g)


def test_bf16_pair_step_matches_jax_kernel(monkeypatch):
    """One bf16 step of a reduced scale-free RDST (one DSTL an RDSTB) at
    1.5 (one LR 8x8 -> HR 12x12) on the train-pair route against the JAX
    step on its kernel."""
    kw = dict(SMALL, rdst_rdb_depths=[1, 1], **SCALE_FREE)
    jp, tp = _paras(JaxParams, TINY, **kw), _paras(ParametersLoader, TINY,
                                                   **kw)
    rng = np.random.default_rng(0)
    batch = {"in": rng.random((1, 8, 8, 1), dtype=np.float32),
             "out": rng.random((1, 12, 12, 1), dtype=np.float32)}
    params = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = jax_build(jp, dtype=dt)
        params[dt] = jm
    p0 = jax.jit(lambda k, v: params[jnp.float32].init(k, v, 1.5))(
        jax.random.PRNGKey(0), jnp.asarray(batch["in"]))
    p0 = jax.tree.map(np.asarray, p0)
    tm = build_generator(tp, dtype=torch.bfloat16)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        export_rdstsr(p0, tm.mean, tm.std).items()})
    assert set_train_mode(tm, "pair") == "pair"
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    monkeypatch.setenv("RDST_TPU_PALLAS_TRAIN", "pair")
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    import rdst_tpu.kernels.pair_train as jpt
    from rdst_tpu_torch.kernels import pair_train as tpt

    calls = {"jax": 0, "port": 0}

    def spy(mod, key):
        orig = mod.fused_swin_pair_train

        def f(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, "fused_swin_pair_train", f)

    spy(jpt, "jax")
    spy(tpt, "port")
    v_j, g_j = _jax_step(jp, params[jnp.bfloat16], p0, batch, 1.5)
    tm.train()
    tparams = [p for p in tm.parameters() if p.requires_grad]
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    pred = tm(torch.from_numpy(batch["in"]), 1.5).float()
    assert pred.shape == (1, 12, 12, 1)
    total, _ = SRLoss(tp)(pred, {"out": torch.from_numpy(batch["out"])},
                          "WarmUP")
    grads = dict(zip(names, torch.autograd.grad(total, tparams)))
    assert calls == {"jax": 2, "port": 2}
    assert abs(float(total.detach()) - v_j) <= 2e-2 * abs(v_j)
    # conv bias gradients: flax sums them in bf16 (test_torch_train.py)
    monkeypatch.setenv("RDST_TPU_PALLAS_TRAIN", "0")
    _, g32 = _jax_step(jp, params[jnp.float32], p0, batch, 1.5)
    want32 = export_rdstsr(g32, tm.mean, tm.std)
    want = export_rdstsr(g_j, tm.mean, tm.std)
    conv_bias = [k for k in grads if k.endswith(".bias") and (
        k.startswith(("head.", "conv_after_body.")) or ".conv." in k)]
    assert len(conv_bias) == 4, conv_bias
    assert any(k.startswith("tail_meta.P2W.") for k in grads)
    ref = {k: np.asarray(want32[k] if k in conv_bias else want[k],
                         np.float32) for k in grads}
    gmax = max(float(np.abs(w).max()) for w in ref.values())
    for k, got in grads.items():
        denom = max(1e-5, float(np.abs(ref[k]).max()), 0.12 * gmax)
        err = float(np.abs(got.float().numpy() - ref[k]).max()) / denom
        assert err < 0.08, (k, err)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("sfdata") / "OASIS" / "example20"
    synthetic.make_oasis_example(
        str(data), patient_ids=("OAS1_0001_MR1", "OAS1_0002_MR1",
                                "OAS1_0003_MR1"), shape=(96, 112, 10))
    return data


def _metasr_over(corpus, out, warm, residual_scale):
    return {"data_folder": str(corpus), "output_dir": str(out),
            "edsr_n_resblocks": 2, "edsr_n_feats": 16, "batch_size": 8,
            "epochs_in_total": {"WarmUP": 3}, "check_every": 100,
            "eva_metrics": "psnr ssim", "multi_threads": 1,
            "training_patient_ids_oasis": ["OAS1_0001_MR1", "OAS1_0002_MR1"],
            "validation_patient_ids_oasis": ["OAS1_0003_MR1"],
            "pre_trained_g": warm, "residual_scale": residual_scale,
            "verbose": False}


@pytest.mark.parametrize("residual_scale", [0.0, 0.5])
def test_metasr_training_matches_jax(corpus, tmp_path, residual_scale):
    """3 steps of the shipped MetaSR recipe, shrunk, from one warm start:
    the port's trainer against the JAX trainer, batch for batch."""
    over = _metasr_over(corpus, tmp_path / "p", "", residual_scale)
    port = build_trainer(["--config-file", METASR, "--gpu-id", "-1"]
                         + [f"{k}={v!r}" for k, v in over.items()])
    warm = str(tmp_path / "warm.msgpack")
    write_snapshot(warm, port.model.state_dict())
    port.paras.set("pre_trained_g", warm)
    port.setup()
    port.train()

    jp = _paras(JaxParams, METASR,
                **_metasr_over(corpus, tmp_path / "j", warm, residual_scale))
    ds_train, ds_valid = jax_datasets(jp)
    jt = JaxTrainer(jp, ds_train, ds_valid, seed=0)
    jt.setup()
    jt.train()
    got = port.training_loss_records["WarmUP"]
    want = jt.training_loss_records["WarmUP"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    recs, pairs = port._infer_pairs(list(range(ds_valid.test_len())))
    jrecs, jpairs = jt._infer_pairs(list(range(ds_valid.test_len())))
    for s in (2.0, 4.0):
        a = np.stack([r[s] for r in recs])
        b = np.stack([r[s] for r in jrecs])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    prep = port.final_eva_func(recs, pairs)
    jrep = jt.final_eva_func(jrecs, jpairs)
    for k in ("psnr_2.0", "psnr_4.0"):
        np.testing.assert_allclose(prep[k], jrep[k], rtol=0, atol=1e-3)
