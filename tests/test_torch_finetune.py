"""The port's fine-tune recipes against ``rdst_tpu``'s on the CPU, at a
reduced RDST (2 RDSTBs, embed 12, growth 6; LR 8x8 -> HR 32x32, batch 4)
with a CNN discriminator (``gan_d_depth`` 3, base 8) and the committed
seg UNet (``weights/unet_tiny.pkl``):

* one whole RaGAN step (the generator forward without gradient, the
  discriminator update, the generator step against the refreshed
  discriminator) and one L1 + UNet-F step of the port's trainer
  (``train_step``) against the JAX trainer's own compiled step
  (``SRTrainer._make_train_step``) from the same parameters and batch:
  the generator's parameters after it within 1e-4, and its Adam moments
  (its gradient) within 2e-5 of each tensor's largest entry, with a check
  that the term beside L1 moves that gradient by ten times as much; the
  discriminator's parameters within 1e-5 (but for entries whose gradient
  is at float32's rounding floor, below 1e-6, which Adam moves by up to
  the learning rate in either package: ``test_torch_adversarial.py`` says
  why, and holds them to twice the rate) and its moments as that file
  holds them; the records ``L1``, ``GAN``, ``UNet-F``, ``Adv_D``,
  ``Adv_D Real``, ``Adv_D Fake`` within 1e-4 relative;
* a discriminator snapshot the port writes (``models/{state}_loss_d.
  msgpack``) is read by the JAX trainer's ``_weights_init_d``, one the JAX
  trainer writes by the port's ``pre_trained_d``; a ``.pt`` file is
  refused;
* a checkpoint with the discriminator resumes to the same state and the
  same next step;
* ``build_trainer`` takes every shipped RDST and SwinIR training config
  with nothing overridden but the data and output paths (FID in
  ``eva_metrics`` included), the MetaSR config too;
* the trainer runs two GAN steps with jax, flax, msgpack, scipy and
  ``rdst_tpu`` unimportable.
"""

import glob
import os
import pathlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.losses.sr_loss import SRLoss as JaxLoss
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.runners.trainer import SRTrainer as JaxTrainer
from rdst_tpu.utils.optim import make_optimizer
from rdst_tpu_torch.checkpoint.convert import (export_discriminator,
                                               export_rdstsr,
                                               import_discriminator)
from rdst_tpu_torch.checkpoint.msgpack_writer import import_rdstsr
from rdst_tpu_torch.cli import build_trainer, train_main
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from test_torch_adversarial import NOISE, _adam_moments, moments_close

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
UNET = str(REPO / "weights" / "unet_tiny.pkl")
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [2, 2], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [1, 1],
         "patch_size": 8, "batch_size": 4, "quick_eva_num_samples": 2,
         "multi_threads": 1, "verbose": False, "learning_rate": 2e-5,
         "lr_decay_type": "milestones 3000", "check_every": 1,
         "eva_metrics": "psnr ssim fid"}
GAN = {"training_states": ["GAN-FT"], "epochs_in_total": {"GAN-FT": 1},
       "loss_scalars": {"GAN-FT": {"L1": 1.0, "GAN": 0.005}},
       "training_losses": ["L1", "GAN"], "gan_type": "RaGAN", "gan_k": 1,
       "gan_d_depth": 3, "gan_d_base_features": 8}
SEG = {"training_states": ["UNet-F"], "epochs_in_total": {"UNet-F": 1},
       "loss_scalars": {"UNet-F": {"L1": 0.1, "UNet-F": 1}},
       "training_losses": ["L1", "UNet-F"],
       "unet_loss_layers": {"encoder-L1": [1]},
       "unet_loss_mode": "OASIS_lesion_only", "unet_native_ckpt": UNET}
# the generator's Adam moments after one step, relative to each tensor's
# largest entry: the two packages' float32 gradients agree to 4e-6 of it
G_MOMENT_RTOL = 2e-5
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "scipy",
           "cv2", "tabulate", "rdst_tpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for torch: the suite runs six workers on the
    CPU, and each worker's default of one thread per core oversubscribes
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "OASIS" / "example"
    synthetic.make_oasis_example(str(root), shape=(40, 48, 24))
    return root


def _over(corpus, out, recipe, **kw):
    return {**SMALL, **recipe, "data_folder": str(corpus),
            "output_dir": str(out), **kw}


def _argv(over, seg=False):
    return (["--config-file", TINY, "--gpu-id", "-1"]
            + (["--seg-loss"] if seg else [])
            + [f"{k}={v!r}" for k, v in over.items()])


def _jax_paras(over):
    p = JaxParams(TINY)
    for k, v in over.items():
        p.set(k, v)
    return p


def _batch(seed=7, n=4):
    rng = np.random.default_rng(seed)
    return {"in": rng.random((n, 8, 8, 1), dtype=np.float32),
            "out": rng.random((n, 32, 32, 1), dtype=np.float32),
            "seg_gt": rng.integers(0, 4, (n, 32, 32, 1)).astype(np.uint8),
            "sr_factor": 4.0}


def _jax_step(over, params, d_state, batch, ts):
    """The JAX trainer's compiled step, built by its own
    ``_make_train_step`` on the attributes that method reads: the new
    generator parameters, discriminator state, report, guard and the
    generator's Adam state."""
    jp = _jax_paras(over)
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.model = jax_build(jp)
    jt.tx = make_optimizer(jp)
    jt.loss = JaxLoss(jp)
    jt.loss_threshold = float(jp.loss_threshold)
    jt.residual_scale = 0.0
    step = jt._make_train_step(ts)
    jb = {"in": jnp.asarray(batch["in"]), "out": jnp.asarray(batch["out"])}
    opt_state = jt.tx.init(params)
    if d_state is None:
        jb["seg_gt"] = jnp.asarray(batch["seg_gt"])
        new_p, new_o, total, report, ok = step(params, opt_state, jb,
                                               jax.random.PRNGKey(3), 4.0)
        return (jax.tree.map(np.asarray, new_p), None, report, ok,
                _adam_moments(new_o))
    jb["sr_scales"] = jnp.full((batch["in"].shape[0], 1), 4.0)
    d_state = dict(d_state,
                   opt_state=jt.loss.adversarial.tx.init(d_state["params"]))
    new_p, new_o, d_state, total, report, ok = step(
        params, opt_state, d_state, jb, jax.random.PRNGKey(3), 4.0)
    return (jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, d_state),
            report, ok, _adam_moments(new_o))


def _port_trainer(over, seg=False):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = build_trainer(_argv(over, seg))
    t.setup()
    return t


def _load_g(trainer, params):
    m = trainer.model
    sd = export_rdstsr(params, m.mean, m.std)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})


def _load_d(trainer, d_state):
    adv = trainer.loss.adversarial
    sd = export_discriminator({"params": d_state["params"],
                               "batch_stats": d_state["batch_stats"]},
                              adv.map_chw)
    adv.discriminator.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()})


def _init(trainer):
    """The JAX tree of the port trainer's seeded generator."""
    return import_rdstsr(trainer.model.state_dict())


def _close_tree(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        err = float(np.abs(got[k].detach().numpy() - want[k]).max())
        assert err <= tol, (k, err)


def _by_name(module, params, flat):
    """A flat optimizer buffer over ``params``, by parameter name."""
    names = {id(p): n for n, p in module.named_parameters()}
    parts = flat.split([p.numel() for p in params])
    return {names[id(p)]: v.view_as(p).detach().numpy()
            for v, p in zip(parts, params)}


def _term_grads(trainer, batch, ts, name):
    """The generator's gradient of one weighted loss term alone, before
    the step (the generator's random state left as it was)."""
    state = trainer.generator.get_state()
    trainer.model.train()
    pred = trainer.model(torch.from_numpy(batch["in"])).float()
    _, report = trainer.loss(pred, trainer.device_batch(batch), ts)
    value = trainer.loss.loss_scalars[ts][name] * report[name]
    grads = (torch.autograd.grad(value, trainer.params, allow_unused=True)
             if value.requires_grad else [None] * len(trainer.params))
    trainer.generator.set_state(state)
    return _by_name(trainer.model, trainer.params,
                    torch.cat([(torch.zeros_like(p) if g is None else g)
                               .reshape(-1)
                               for g, p in zip(grads, trainer.params)]))


@pytest.mark.parametrize("recipe", ["gan", "seg"])
def test_finetune_step_matches_jax(corpus, tmp_path, recipe):
    """The parameters after one step are within 1e-4, but a first Adam
    step moves an entry by at most the learning rate (2e-5), so they
    cannot show the gradient: the generator's Adam moments (its gradient
    and its square) are held within G_MOMENT_RTOL of each tensor's
    largest entry, and the term beside L1 (GAN or UNet-F) must move some
    tensor's gradient by ten times that, so that a term that does not
    reach the generator, a flipped sign or a wrong weight fails."""
    over = _over(corpus, tmp_path, GAN if recipe == "gan" else SEG)
    ts = over["training_states"][0]
    trainer = _port_trainer(over, seg=recipe == "seg")
    params = _init(trainer)
    _load_g(trainer, params)
    d_state = None
    if recipe == "gan":
        adv = trainer.loss.adversarial
        d_state = import_discriminator(adv.discriminator.state_dict(),
                                       adv.map_chw)
        _load_d(trainer, d_state)
    batch = _batch()
    term = _term_grads(trainer, batch, ts,
                       "GAN" if recipe == "gan" else "UNet-F")
    want_p, want_d, j_rep, j_ok, g_adam = _jax_step(over, params, d_state,
                                                    batch, ts)
    total, report, ok = trainer.train_step(batch, ts)
    assert bool(ok) and bool(j_ok)
    assert sorted(report) == sorted(j_rep)
    assert set(report) >= ({"L1", "GAN", "Adv_D", "Adv_D Real", "Adv_D Fake"}
                           if recipe == "gan" else {"L1", "UNet-F"})
    for k in j_rep:
        want = float(j_rep[k])
        assert abs(float(report[k]) - want) <= 1e-4 * max(abs(want), 1e-3), k
    m = trainer.model
    want_sd = export_rdstsr(want_p, m.mean, m.std)
    _close_tree(dict(m.state_dict()), want_sd, 1e-4)
    opt = trainer.opt
    g_want = {key: export_rdstsr(
        jax.tree.map(np.asarray, getattr(g_adam, key)), m.mean, m.std)
        for key in ("mu", "nu")}
    g_got = {key: _by_name(m, trainer.params, opt.state[key])
             for key in ("mu", "nu")}
    g_want = {key: {k: g_want[key][k] for k in g_got[key]}
              for key in g_want}
    moments_close(g_got, g_want, g_want["nu"], opt.b1, opt.b2, 1,
                  rtol=G_MOMENT_RTOL, noise_floor=0.0)
    share = max(float(np.abs(term[k]).max())
                / float(np.abs(g_want["mu"][k]).max() / (1 - opt.b1))
                for k in term if np.abs(g_want["mu"][k]).max() > 0)
    assert share >= 10 * G_MOMENT_RTOL, share
    if recipe == "gan":
        adv = trainer.loss.adversarial
        want_dsd = export_discriminator(
            {"params": want_d["params"], "batch_stats": want_d["batch_stats"]},
            adv.map_chw)
        d_adam = _adam_moments(want_d["opt_state"])
        d_want = {key: export_discriminator({"params": getattr(d_adam, key)},
                                            adv.map_chw)
                  for key in ("mu", "nu")}
        nu = d_want["nu"]
        got = dict(adv.discriminator.state_dict())
        for k, v in want_dsd.items():
            err = np.abs(got[k].numpy() - v)
            noise = (np.sqrt(nu[k] / (1 - adv.opt.b2)) < NOISE if k in nu
                     else np.zeros(v.shape, bool))
            assert float(err[~noise].max(initial=0)) <= 1e-5, k
            assert float(err[noise].max(initial=0)) <= 2 * 2e-5, k
        moments_close({key: _by_name(adv.discriminator, adv.params,
                                     adv.opt.state[key])
                       for key in ("mu", "nu")}, d_want, nu, adv.opt.b1,
                      adv.opt.b2, 1)


def _jax_d_reader(over, path):
    """The JAX trainer's ``_weights_init_d`` on a fresh discriminator."""
    jp = _jax_paras({**over, "pre_trained_d": str(path)})
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.paras = jp
    jt.loss = JaxLoss(jp)
    jt.d_state = jt.loss.adversarial.init(jax.random.PRNGKey(1),
                                          jnp.zeros((1, 32, 32, 1)))
    assert "pre-trained" in jt._weights_init_d()
    return jax.tree.map(np.asarray, jt.d_state)


def test_d_snapshots_cross_and_checkpoint_resumes(corpus, tmp_path):
    over = _over(corpus, tmp_path / "a", GAN,
                 epochs_in_total={"GAN-FT": 2}, check_every=2)
    first = train_main(_argv(over))
    adv = first.loss.adversarial
    models = pathlib.Path(first.dirs["models"])
    assert (models / "GAN-FT_model_g.msgpack").is_file()
    dpath = models / "GAN-FT_loss_d.msgpack"
    recs = first.loss.records["GAN-FT"]
    assert {"L1", "GAN", "Adv_D", "Adv_D Real", "Adv_D Fake"} <= set(recs)
    assert adv.opt.count == 2
    # the port's snapshot, read by the JAX trainer
    got = _jax_d_reader(over, dpath)
    _close_tree(dict(adv.discriminator.state_dict()),
                export_discriminator({"params": got["params"],
                                      "batch_stats": got["batch_stats"]},
                                     adv.map_chw), 0.0)
    # a JAX trainer's snapshot (its whole d_state), read by the port
    jstate = JaxLoss(_jax_paras(over)).adversarial.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 1)))
    jpath = tmp_path / "jax_loss_d.msgpack"
    jpath.write_bytes(serialization.to_bytes(jstate))
    warm = _port_trainer(_over(corpus, tmp_path / "b", GAN,
                               pre_trained_d=str(jpath)))
    wadv = warm.loss.adversarial
    _close_tree(dict(wadv.discriminator.state_dict()),
                export_discriminator(jax.tree.map(np.asarray, {
                    "params": jstate["params"],
                    "batch_stats": jstate["batch_stats"]}), wadv.map_chw),
                0.0)
    assert wadv.opt.count == 0
    with pytest.raises(ValueError, match="msgpack"):
        pt = tmp_path / "d.pt"
        pt.write_bytes(b"")
        _port_trainer(_over(corpus, tmp_path / "c", GAN,
                            pre_trained_d=str(pt)))
    # resume: the checkpoint of step 2 restores G, D and both optimizers
    second = _port_trainer({**over, "epochs_in_total": {"GAN-FT": 3}})
    assert second.step == 2 and second.loss.adversarial.opt.count == 2
    for a, b in ((first.model, second.model),
                 (adv.discriminator, second.loss.adversarial.discriminator)):
        for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(u, v), k
    for k, v in adv.opt.state.items():
        assert torch.equal(v, second.loss.adversarial.opt.state[k])
    batch = _batch(9)
    steps = [t.train_step(batch, "GAN-FT") for t in (first, second)]
    for k in steps[0][1]:
        assert torch.equal(steps[0][1][k], steps[1][1][k]), k
    for u, v in zip(first.params, second.params):
        assert torch.equal(u, v)


SHIPPED = sorted(glob.glob(str(REPO / "config_files" / "*.ini")))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Small seeded corpora under the shipped patient ids, one per data
    folder the shipped configs name."""
    root = tmp_path_factory.mktemp("corpora")
    ids = {n: tuple(f"OAS1_{i:04d}_MR1" for i in range(1, n + 1))
           for n in (4, 20)}
    synthetic.make_oasis_example(str(root / "OASIS" / "example"),
                                 patient_ids=ids[4], shape=(56, 60, 6))
    synthetic.make_oasis_example(str(root / "OASIS" / "example20"),
                                 patient_ids=ids[20], shape=(56, 60, 6))
    synthetic.make_brats_example(
        str(root / "BraTS" / "example8"), shape=(40, 44, 4),
        patient_ids=tuple(f"HGG_Brats17_SYN_{i:03d}_1" for i in range(1, 9)))
    synthetic.make_acdc_example(
        str(root / "ACDC" / "example8"), shape=(40, 44, 3),
        patient_ids=tuple(f"patient{i:03d}" for i in range(1, 9)))
    synthetic.make_covid_example(
        str(root / "COVID" / "example8"), shape=(64, 64, 3),
        patient_ids=tuple(f"volume-covid19-A-{i:04d}" for i in range(1, 9)))
    return root


@pytest.mark.parametrize("config", SHIPPED, ids=os.path.basename)
def test_build_trainer_takes_the_shipped_config(config, corpora, tmp_path):
    paras = ParametersLoader(config)
    folder = paras.data_folder.split("data/", 1)[1].rstrip("/")
    argv = ["--config-file", config, "--gpu-id", "-1",
            f"data_folder='{corpora / folder}'", f"output_dir='{tmp_path}'"]
    if "UNet-F" in paras.training_losses:
        argv.append("--seg-loss")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = build_trainer(argv)
    metrics = trainer.final_eva_func.func
    assert ("fid" in metrics.fid_functions) == ("fid" in paras.eva_metrics)
    if any("GAN" in n for n in paras.training_losses):
        assert trainer.loss.adversarial is not None


def test_trains_without_jax_flax_msgpack_scipy(corpus, tmp_path):
    argv = _argv(_over(corpus, tmp_path, GAN,
                       epochs_in_total={"GAN-FT": 2}, check_every=2))
    script = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
from rdst_tpu_torch.cli import train_main
t = train_main({argv!r})
assert t.step == 2, t.step
rec = t.loss.records["GAN-FT"]
assert len(rec["Adv_D"]) == 2 and all(v == v for v in rec["GAN"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
