"""The port's auxiliary trainers against ``rdst_tpu``'s on the CPU:

* ``runners.train_seg_unet`` (the segmentation UNet, cross-entropy + Dice,
  BatchNorm in train mode) and ``runners.train_vgg_features`` (the VGG19
  feature stack as a denoising autoencoder's encoder, width 0.25), three
  steps at patch 32 from the JAX trainer's own initial variables (built
  here with ``jax.random.PRNGKey(seed)`` and the JAX module's ``init`` at
  the JAX trainer's shapes, passed to the port's ``init_variables``) on
  the batches both draw from one numpy seed: losses within 1e-4
  relative, every parameter (and running statistic) within 1e-4 of its
  tensor's largest entry;
* ``F.interpolate(mode='nearest')`` at x2 gives ``jax.image.resize``'s
  values;
* the pickles cross both ways: each package's UNet loads into the
  other's ``UNet-F`` term (the same loss, 1e-5) and ``seg_eval`` (the same
  Dice), each package's VGG stack into the other's ``VGGLoss`` (1e-5).
"""

import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.runners.train_seg_unet import train_seg_unet as jax_seg_train
from rdst_tpu.runners.train_vgg_features import \
    train_vgg_features as jax_vgg_train
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.data.readers import make_test_dataset
from rdst_tpu_torch.runners.seg_eval import seg_eval
from rdst_tpu_torch.runners.train_seg_unet import train_seg_unet
from rdst_tpu_torch.runners.train_vgg_features import train_vgg_features

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
PATCH, SEED, STEPS = 32, 3, 3
# float32 seg-UNet losses after 1-2 updates, either package against the
# other (each departs from the float64 run by up to 3e-4)
SEG_F32_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("aux")
    data = root / "OASIS" / "example"
    synthetic.make_oasis_example(str(data), shape=(40, 48, 24))
    return root


def _paras(cls, corpus, **kw):
    p = cls(CONFIG)
    for k, v in {"data_folder": str(corpus / "OASIS" / "example"),
                 "output_dir": str(corpus / "out"), "verbose": False,
                 "multi_threads": 1, **kw}.items():
        p.set(k, v)
    return p


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _close_trees(got, want, tol=1e-4):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * float(np.abs(w).max()), (k, err)


@pytest.fixture(scope="module")
def seg_runs(corpus):
    """Three steps of each package's seg-UNet trainer from the JAX init."""
    from rdst_tpu.models.seg_unet import SegUNet as JaxSegUNet

    init = jax.jit(lambda r, x: JaxSegUNet(in_channels=1, classes=4).init(
        r, x, train=False))(jax.random.PRNGKey(SEED),
                            jnp.zeros((1, PATCH, PATCH, 1)))
    init = jax.tree.map(np.asarray, init)
    kw = dict(steps=STEPS, batch_size=8, patch=PATCH, seed=SEED,
              log_every=1, verbose=False)
    want, want_losses = jax_seg_train(_paras(JaxParams, corpus), **kw)
    got, losses = train_seg_unet(_paras(ParametersLoader, corpus), **kw,
                                 device="cpu", init_variables=init)
    return {"jax": (jax.tree.map(np.asarray, want), want_losses),
            "port": (got, losses)}


def test_seg_unet_trainer_matches_jax(seg_runs):
    """Three float32 steps of both trainers. The first loss (the forward
    at the shared init) within 1e-5; the later ones within SEG_F32_RTOL:
    in float32 both packages depart from the float64 run by 1e-4 - 3e-4
    relative after one or two updates (train-mode BatchNorm over 8 values
    at the 1x1 stage, fed to Adam's first, sign-like steps), so neither
    holds 1e-4 of the other; the exact comparison is in float64 below."""
    (want, want_losses), (got, losses) = seg_runs["jax"], seg_runs["port"]
    assert len(losses) == len(want_losses) == STEPS
    assert abs(losses[0] - want_losses[0]) <= 1e-5 * want_losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=SEG_F32_RTOL)
    assert losses[-1] < losses[0]
    assert sorted(got) == ["batch_stats", "params"]
    assert sorted(dict(_leaves(got))) == sorted(dict(_leaves(want)))


def _jax_seg_loss(model, stats, x, labels, n_classes):
    """The JAX trainer's loss (its ``train_step.loss_fn``), with the
    updated running statistics."""
    import optax

    from rdst_tpu.losses.seg_unet import dice_loss as jax_dice

    def loss_fn(p):
        (_, _, logits), upd = model.apply(
            {"params": p, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels.astype(jnp.int32)).mean()
        return ce + jax_dice(logits, labels, list(range(n_classes))), \
            upd["batch_stats"]

    return loss_fn


def test_seg_unet_step_matches_jax_in_float64(corpus):
    """The trainer's loss, gradients and running-statistics update on its
    first batch, in float64 on both sides (the JAX loss under
    ``jax.enable_x64``): loss within 1e-9 relative, every gradient within
    1e-6 of its tensor's largest entry, running statistics within 1e-6
    (flax stores them in float32);
    then one update of the port's ``adam`` against ``optax.adam`` on the
    float32 gradients (each parameter within one float32 ulp and 1e-6 of
    the learning rate)."""
    import optax

    from rdst_tpu.models.seg_unet import SegUNet as JaxSegUNet
    from rdst_tpu_torch.checkpoint.convert import import_flax_tree
    from rdst_tpu_torch.runners.train_seg_unet import SegUNetTrainer

    model = JaxSegUNet(in_channels=1, classes=4)
    init = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: model.init(r, x, train=False))(
            jax.random.PRNGKey(SEED), jnp.zeros((1, PATCH, PATCH, 1))))
    trainer = SegUNetTrainer(_paras(ParametersLoader, corpus), batch_size=8,
                             patch=PATCH, seed=SEED, device="cpu",
                             init_variables=init)
    batch = trainer.ds.sample(np.random.default_rng(SEED))
    labels = batch["seg_gt"][..., 0]
    trainer.model.double()
    loss, _ = trainer.loss(torch.from_numpy(batch["out"]).double(),
                           torch.from_numpy(labels).long())
    grads = torch.autograd.grad(loss, trainer.params)
    names = [n for n, _ in trainer.model.named_parameters()]
    got = import_flax_tree(dict(zip(names, grads)))["params"]
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), init)
        fn = _jax_seg_loss(JaxSegUNet(in_channels=1, classes=4,
                                      dtype=jnp.float64), f64["batch_stats"],
                           jnp.asarray(batch["out"], jnp.float64),
                           jnp.asarray(labels, jnp.float64), 4)
        (want_loss, want_stats), want = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(f64["params"])
        want_loss = float(want_loss)
        want = jax.tree.map(np.asarray, want)
        want_stats = jax.tree.map(np.asarray, want_stats)
    assert abs(loss.item() - want_loss) <= 1e-9 * want_loss
    _close_trees(got, want, tol=1e-6)
    stats = {k: v.double() for k, v in trainer.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    # flax keeps its running statistics in float32
    _close_trees(import_flax_tree(stats)["batch_stats"], want_stats,
                 tol=1e-6)

    # one update of each optimizer on the same float32 gradients
    trainer.model.float()
    from rdst_tpu_torch.utils.optim import adam

    params = [p.detach().clone() for p in trainer.params]
    g32 = [g.float() for g in grads]
    adam(params, 1e-3).step(g32)
    tx = optax.adam(1e-3)
    p0 = [p.detach().numpy() for p in trainer.params]
    upd, _ = tx.update([g.numpy() for g in g32], tx.init(p0), p0)
    for p, u in zip(params, optax.apply_updates(p0, upd)):
        # equal up to the float32 rounding of the sum and of the update
        u = np.asarray(u)
        assert np.all(np.abs(p.numpy() - u) <= np.spacing(np.abs(u))
                      + 1e-6 * 1e-3)


def test_nearest_x2_is_jax_resize():
    x = np.random.default_rng(0).random((2, 5, 3, 4), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), "nearest")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_dae(width):
    """The JAX trainer's autoencoder, module for module (its own class is
    local to the trainer), to draw its initial variables."""
    from flax import linen as nn

    from rdst_tpu.losses.vgg import _TAPS, VGG19Features
    from rdst_tpu.nn.layers import torch_conv_init

    class DAE(nn.Module):
        @nn.compact
        def __call__(self, x):
            y = VGG19Features(tap=_TAPS["54"], width=width,
                              name="encoder")(x)
            for i, ch in enumerate((128, 64, 32, 16)):
                b, h, w, _ = y.shape
                y = jax.image.resize(y, (b, h * 2, w * 2, y.shape[-1]),
                                     "nearest")
                y = nn.Conv(max(8, int(ch * width * 4)), (3, 3), padding=1,
                            kernel_init=torch_conv_init, name=f"dec_{i}")(y)
                y = jax.nn.relu(y)
            return nn.Conv(x.shape[-1], (3, 3), padding=1,
                           kernel_init=torch_conv_init, name="dec_out")(y)

    return DAE()


@pytest.fixture(scope="module")
def vgg_runs(corpus):
    init = jax.jit(_jax_dae(0.25).init)(jax.random.PRNGKey(SEED),
                                        jnp.zeros((1, PATCH, PATCH, 3)))
    kw = dict(steps=STEPS, width=0.25, batch_size=4, patch=PATCH, seed=SEED,
              log_every=1, verbose=False)
    want = jax_vgg_train(_paras(JaxParams, corpus), **kw)
    got = train_vgg_features(_paras(ParametersLoader, corpus), **kw,
                             device="cpu",
                             init_variables=jax.tree.map(np.asarray, init))
    return {"jax": jax.tree.map(np.asarray, want), "port": got}


def test_vgg_feature_trainer_matches_jax(vgg_runs):
    want, got = vgg_runs["jax"], vgg_runs["port"]
    assert got["width"] == want["width"] == 0.25
    assert len(got["losses"]) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert sorted(got["params"]) == [f"conv_{i}" for i in range(16)] \
        or sorted(got["params"]) == sorted(want["params"])
    _close_trees(got["params"], want["params"])


def _save(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def test_unet_pickles_cross_both_ways(seg_runs, corpus, tmp_path):
    """Each package's trained UNet in the other's UNet-F term and
    seg_eval."""
    from rdst_tpu.losses.seg_unet import SegUNetLoss as JaxSegLoss
    from rdst_tpu.runners.seg_eval import seg_eval as jax_seg_eval
    from rdst_tpu_torch.losses.seg_unet import SegUNetLoss

    port_pkl = _save(seg_runs["port"][0], tmp_path / "port_unet.pkl")
    jax_pkl = _save(seg_runs["jax"][0], tmp_path / "jax_unet.pkl")
    rng = np.random.default_rng(5)
    pred, target = (rng.random((2, 32, 32, 1), dtype=np.float32)
                    for _ in range(2))
    layers = {"encoder-L1": [1, 2]}
    for pkl in (port_pkl, jax_pkl):
        jp = _paras(JaxParams, corpus, unet_native_ckpt=pkl,
                    unet_loss_layers=layers)
        tp = _paras(ParametersLoader, corpus, unet_native_ckpt=pkl,
                    unet_loss_layers=layers)
        want = float(JaxSegLoss(jp)(jnp.asarray(pred), jnp.asarray(target)))
        with torch.no_grad():
            got = float(SegUNetLoss(tp)(torch.from_numpy(pred),
                                        torch.from_numpy(target)))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (pkl, got, want)

    # seg_eval of both packages over one saved SR volume
    out = tmp_path / "out"
    tp = _paras(ParametersLoader, corpus, output_dir=str(out))
    jp = _paras(JaxParams, corpus, output_dir=str(out))
    pid = list(tp.testing_patient_ids_oasis)[0]
    ds = make_test_dataset(tp, [pid])
    gts = np.stack([ds.get_test_pair(i)[4.0]["gt"]
                    for i in range(ds.test_len())])
    inf = out / "RDST_TINY_OASIS_SRx4_None_Final_Predictions" / \
        "inference_results"
    inf.mkdir(parents=True)
    sr = gts + 0.05 * np.random.default_rng(2).standard_normal(gts.shape)
    np.savez_compressed(inf / f"{pid}_inference_results.npz",
                        **{"x4.0": sr.astype(np.float32)})
    want, _ = jax_seg_eval(jp, port_pkl, verbose=False)
    got, _ = seg_eval(tp, jax_pkl, verbose=False, device="cpu")
    mine, _ = seg_eval(tp, port_pkl, verbose=False, device="cpu")
    np.testing.assert_allclose(mine, want, rtol=0, atol=1e-6)
    assert got.shape == want.shape and np.isfinite(got).all()


def test_vgg_pickles_cross_both_ways(vgg_runs, tmp_path, monkeypatch):
    """Each package's trained stack in the other's VGGLoss (the committed
    substitute's place, ``RDST_TPU_VGG19_NATIVE``)."""
    from rdst_tpu.losses.vgg import VGGLoss as JaxVGGLoss
    from rdst_tpu_torch.losses.vgg import VGGLoss

    monkeypatch.setenv("RDST_TPU_VGG19_PT", str(tmp_path / "absent.pt"))
    rng = np.random.default_rng(6)
    pred, target = (rng.random((2, 32, 32, 1), dtype=np.float32)
                    for _ in range(2))
    for name, blob in (("port", vgg_runs["port"]), ("jax", vgg_runs["jax"])):
        monkeypatch.setenv("RDST_TPU_VGG19_NATIVE",
                           _save(blob, tmp_path / f"{name}_vgg.pkl"))
        for term in ("VGG22", "VGG54"):
            want = float(JaxVGGLoss(term)(jnp.asarray(pred),
                                          jnp.asarray(target)))
            loss = VGGLoss(term)
            assert loss.model.width == 0.25
            with torch.no_grad():
                got = float(loss(torch.from_numpy(pred),
                                 torch.from_numpy(target)))
            assert np.isfinite(got) and got > 0.0
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), \
                (name, term, got, want)
