"""The port's discriminators and adversarial losses against ``rdst_tpu``'s
on the CPU, with the JAX package's weights carried across
(``checkpoint.convert.export_discriminator``):

* each discriminator's forward in eval and in training mode (batch
  statistics, and the running statistics it leaves): 1e-5 -- the CNN one
  (``gan_d_depth`` 3, base 8) at 32x32 and at a non-square 32x40 map,
  which catches a wrong order of ``classifier_0``'s reordered rows; the
  Swin one with patch-merging downsampling (its conv downsampling in the
  ``RaGAN-ST`` step below); the ``*GP*`` types without BatchNorm;
* ``build_discriminator`` picks the same class for each ``gan_type``;
* one ``d_step`` for each ``gan_type`` (two updates for GAN): the
  discriminator's parameters and BatchNorm running statistics after it
  within 1e-5, Adam's moments within 1e-5 and within 1e-4 of each
  tensor's largest entry (the second moment is far below 1e-5), and the
  reported losses; WGAN-GP takes
  the JAX package's interpolation draw; WGAN's clip holds; a refused
  update (a nan batch) leaves parameters, moments, count and statistics
  as they were. One exception, by Adam's arithmetic: an entry whose
  gradient is 0 in exact arithmetic (RaGAN's loss does not move when
  every logit shifts by the same amount, so the last bias has none) gets
  a gradient of rounding noise in either package, which Adam's
  g / (|g| + eps) turns into a step of up to the learning rate, of either
  sign. Entries whose gradient is at the float32 rounding floor of the
  O(1) sums it comes from -- below 1e-6 (``sqrt(nu_hat)``; one ulp of 1
  is 1.2e-7) -- are held to twice the learning rate a step instead;
* the generator's objective for each type: 1e-5, and its gradient.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.losses import discriminators as jd
from rdst_tpu.losses.adversarial import ScaleAdversarial as JaxAdv
from rdst_tpu_torch.checkpoint.convert import (export_discriminator,
                                               import_discriminator)
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.losses import discriminators as td
from rdst_tpu_torch.losses.adversarial import ScaleAdversarial

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
D_SMALL = {"patch_size": 8, "gan_d_depth": 3, "gan_d_base_features": 8,
           "stgan_dim": 8, "stgan_input_resolution": (32, 32),
           "stgan_num_heads": (2,), "stgan_depth": (2,),
           "stgan_window_size": (4,), "gan_k": 1, "wgan_clip_value": 0.01,
           "learning_rate": 2e-5, "lr_decay_type": "milestones 3000"}
TOL = 1e-5
# Adam's moments, relative to each tensor's largest entry: the two
# packages' float32 gradients agree to 2e-5 of it here
MOMENT_RTOL = 1e-4
# a gradient below this is float32 rounding noise of O(1) sums (see above)
NOISE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for torch: the suite runs six workers on the
    CPU, and each worker's default of one thread per core oversubscribes
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paras(cls, gan_type, **kw):
    p = cls(TINY)
    for k, v in {**D_SMALL, "gan_type": gan_type, **kw}.items():
        p.set(k, v)
    return p


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_stats(variables, seed=3):
    """Running statistics away from 0 / 1, so that eval mode is tested."""
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda v: (rng.normal(0, 0.2, v.shape) + (1.0 if v.min() > 0 else 0)
                   ).astype(np.float32), _np(variables.get("batch_stats", {})))
    params = jax.tree.map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.05, v.shape)
                   ).astype(np.float32) if v.ndim == 1 else np.asarray(v),
        _np(variables["params"]))
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _load(module, variables, map_chw):
    sd = export_discriminator(variables, map_chw)
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()})
    return module


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _images(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


CASES = {
    "cnn": (lambda: jd.CNNDiscriminator(1, 8, 3),
            lambda: td.CNNDiscriminator(1, 8, 3, patch_size=32), (32, 32)),
    "cnn_nonsquare": (lambda: jd.CNNDiscriminator(1, 8, 3),
                      lambda: td.CNNDiscriminator(1, 8, 3,
                                                  patch_size=(32, 40)),
                      (32, 40)),
    "cnn_gp": (lambda: jd.CNNDiscriminator(1, 8, 3, bn=False),
               lambda: td.CNNDiscriminator(1, 8, 3, patch_size=32, bn=False),
               (32, 32)),
    # one stage: its two blocks (shift 0 and 2) and the patch merging
    "st_merge": (lambda: jd.STDiscriminator(1, 8, (32, 32), (2,), (2,),
                                            (4,), "patchmerging"),
                 lambda: td.STDiscriminator(1, 8, (32, 32), (2,), (2,),
                                            (4,), "patchmerging"),
                 (32, 32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_discriminator_forward_both_modes(case):
    jmake, tmake, hw = CASES[case]
    jm, tm = jmake(), tmake()
    x = _images(0, (3,) + hw + (1,))
    variables = _perturb_stats(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    map_chw = getattr(tm, "map_chw", None)
    _load(tm, variables, map_chw)
    bn = "batch_stats" in variables

    def both(v, x):
        """Eval mode and, with BatchNorm, training mode: one compile."""
        out = jm.apply(v, x, train=False)
        return (out,) + (jm.apply(v, x, train=True, mutable=["batch_stats"])
                         if bn else ())

    want_eval, *train = jax.jit(both)(variables, jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x), train=False).numpy(),
               np.asarray(want_eval))
        if bn:
            want, upd = train
            got = tm(torch.from_numpy(x), train=True).numpy()
            _close(got, np.asarray(want))
            back = import_discriminator(tm.state_dict(), map_chw)
            for a, b in zip(jax.tree_util.tree_leaves(back["batch_stats"]),
                            jax.tree_util.tree_leaves(_np(upd["batch_stats"]))):
                _close(a, b)
    # the layout round trip is exact
    back = import_discriminator(tm.state_dict(), map_chw)
    assert jax.tree_util.tree_structure(back["params"]) == \
        jax.tree_util.tree_structure(variables["params"])


@pytest.mark.parametrize("gan_type", ["GAN", "RaGAN", "WGAN", "WGAN-GP",
                                      "ScaleGAN", "RaGAN-ST", "WGAN-GP-ST"])
def test_build_discriminator_same_class(gan_type):
    j = jd.build_discriminator(_paras(JaxParams, gan_type))
    t = td.build_discriminator(_paras(ParametersLoader, gan_type))
    assert type(j).__name__ == type(t).__name__
    assert j.bn == (t.head.bn is not None if hasattr(t, "head")
                    else t.features_0.bn is not None)


@pytest.mark.parametrize("gan_type", ["RaGAN", "RaGAN-ST"])
def test_fresh_discriminator_draws_as_jax(gan_type):
    """A fresh discriminator is drawn as the JAX package draws one (flax's
    lecun_normal for the BasicBlock convs, truncated normal 0.02 for the
    dense kernels, torch's uniform for the Swin blocks' convs): each
    kernel's mean square within a factor 1.5 of the JAX init's, at 16
    base features so that the smallest kernel has 144 entries (a uniform
    draw within sqrt(1 / fan_in) in place of lecun_normal is a factor 3);
    biases, norms and statistics equal."""
    kw = {"gan_d_base_features": 16, "stgan_dim": 16}
    ja = JaxAdv(_paras(JaxParams, gan_type, **kw))
    ta = ScaleAdversarial(_paras(ParametersLoader, gan_type, **kw))
    ta.init("cpu", torch.Generator().manual_seed(0))
    v = jax.jit(ja.discriminator.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 32, 1)))
    want = export_discriminator(_np(dict(v)), ta.map_chw)
    got = {k: t.detach().numpy()
           for k, t in ta.discriminator.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        ratio = float(np.mean(got[k] ** 2) / np.mean(w ** 2))
        assert 1 / 1.5 <= ratio <= 1.5, (k, ratio)


def _pair(gan_type, seed=0, **kw):
    """(JAX adversary, its state, port adversary with the same weights):
    the port's seeded discriminator, its statistics moved off 0 / 1, in
    the JAX layout (``import_discriminator``) and back."""
    ja = JaxAdv(_paras(JaxParams, gan_type, **kw))
    ta = ScaleAdversarial(_paras(ParametersLoader, gan_type, **kw))
    ta.init("cpu", torch.Generator().manual_seed(seed))
    v = _perturb_stats(import_discriminator(ta.discriminator.state_dict(),
                                            ta.map_chw), seed + 3)
    state = {"params": jax.tree.map(jnp.asarray, v["params"]),
             "batch_stats": jax.tree.map(jnp.asarray,
                                         v.get("batch_stats", {})),
             "opt_state": ja.tx.init(v["params"])}
    _load(ta.discriminator, v, ta.map_chw)
    ta.reset_optimizer()
    return ja, state, ta


def _adam_moments(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _flat_by_name(ta, flat):
    names = [n for n, _ in ta.discriminator.named_parameters()]
    parts = flat.split([p.numel() for p in ta.params])
    return {n: v.view_as(p).detach().numpy()
            for n, v, p in zip(names, parts, ta.params)}


def moments_close(got: dict, want: dict, nu: dict, b1: float, b2: float,
                  count: int, rtol: float = MOMENT_RTOL,
                  noise_floor: float = NOISE) -> None:
    """Adam's ``mu`` and ``nu`` (``{key: {name: array}}``) against JAX's:
    within TOL, and within ``rtol`` of each tensor's largest entry, so
    that the second moment, far below 1 after a few updates, is held as
    tightly as the first (a wrong ``b2`` moves it by its factor). Entries
    whose gradient is rounding noise (``sqrt(nu_hat)`` below
    ``noise_floor`` in JAX's moments ``nu``) are left out of the relative
    comparison; there the port's moments must be noise too (a debiased
    gradient below 10 ``noise_floor``)."""
    for key, debias in (("mu", 1 - b1 ** count), ("nu", 1 - b2 ** count)):
        for k, w in want[key].items():
            g = got[key][k]
            _close(g, w)
            noise = np.sqrt(nu[k] / (1 - b2 ** count)) < noise_floor
            err = np.abs(g - w)[~noise].max(initial=0)
            scale = np.abs(w[~noise]).max(initial=0)
            assert err <= rtol * scale, (key, k, err, scale)
            hat = np.abs(g[noise]) / debias
            if key == "nu":
                hat = np.sqrt(hat)
            assert hat.max(initial=0) <= 10 * noise_floor, (key, k)


def _check_state(ja_state, ta):
    """Parameters, Adam moments and running statistics against JAX."""
    chw = ta.map_chw
    want = export_discriminator({"params": _np(ja_state["params"]),
                                 "batch_stats": _np(ja_state["batch_stats"])},
                                chw)
    got = {k: v.detach().numpy()
           for k, v in ta.discriminator.state_dict().items()}
    assert sorted(got) == sorted(want)
    adam = _adam_moments(ja_state["opt_state"])
    count = int(adam.count)
    nu = export_discriminator({"params": _np(adam.nu)}, chw)
    b1, b2 = float(ta.opt.b1), float(ta.opt.b2)
    lr = float(ta.paras.learning_rate)
    for k in want:
        if k not in nu:  # running statistics
            _close(got[k], want[k])
            continue
        noise = np.sqrt(nu[k] / (1 - b2 ** count)) < NOISE
        _close(np.where(noise, want[k], got[k]), want[k])
        err = np.abs(got[k] - want[k])[noise]
        assert not err.size or float(err.max()) <= 2 * lr * count
    moments_close(
        {key: _flat_by_name(ta, ta.opt.state[key]) for key in ("mu", "nu")},
        {key: export_discriminator({"params": _np(getattr(adam, key))}, chw)
         for key in ("mu", "nu")}, nu, b1, b2, count)
    assert count == ta.opt.count


def _batch(seed=1, n=3):
    rng = np.random.default_rng(seed)
    fake = rng.random((n, 32, 32, 1), dtype=np.float32)
    real = rng.random((n, 32, 32, 1), dtype=np.float32)
    scales = np.full((n, 1), 4.0, np.float32)
    return fake, real, scales


@pytest.mark.parametrize("gan_type,k", [
    ("GAN", 2), ("RaGAN", 1), ("WGAN", 1), ("WGAN-GP", 1), ("ScaleGAN", 1),
    ("RaGAN-ST", 1)])
def test_d_step_matches_jax(gan_type, k):
    ja, state, ta = _pair(gan_type, gan_k=k)
    fake, real, scales = _batch()
    rng = jax.random.PRNGKey(5)
    # WGAN-GP: the port takes the JAX package's interpolation draw
    ta.gp_alpha = lambda n, i, g=None: torch.from_numpy(np.asarray(
        jax.random.uniform(jax.random.fold_in(rng, i), (n, 1, 1, 1))))
    new_state, j_rep = jax.jit(ja.d_step)(state, jnp.asarray(fake),
                                          jnp.asarray(real),
                                          jnp.asarray(scales), rng)
    t_rep = ta.d_step(torch.from_numpy(fake), torch.from_numpy(real),
                      torch.from_numpy(scales))
    assert sorted(t_rep) == sorted(j_rep)
    for name in j_rep:
        _close(float(t_rep[name]), float(j_rep[name]))
    _check_state(new_state, ta)
    if gan_type == "WGAN":
        assert max(float(p.abs().max()) for p in ta.params) <= 0.01


@pytest.mark.parametrize("gan_type", ["RaGAN", "WGAN-GP"])
def test_refused_d_step_leaves_the_state(gan_type):
    ta = ScaleAdversarial(_paras(ParametersLoader, gan_type))
    ta.init("cpu")
    fake, real, scales = _batch()
    ta.d_step(torch.from_numpy(fake), torch.from_numpy(real),
              torch.from_numpy(scales))  # a first accepted update
    before = {k: v.clone() for k, v in ta.discriminator.state_dict().items()}
    moments = {k: v.clone() for k, v in ta.opt.state.items()}
    count = ta.opt.count
    fake[0, 3, 3, 0] = np.nan
    rep = ta.d_step(torch.from_numpy(fake), torch.from_numpy(real),
                    torch.from_numpy(scales))
    assert not np.isfinite(float(rep["Adv_D"]))
    for k, v in ta.discriminator.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in ta.opt.state.items():
        assert torch.equal(v, moments[k]), k
    assert ta.opt.count == count == 1


@pytest.mark.parametrize("gan_type", ["GAN", "RaGAN", "WGAN", "ScaleGAN"])
def test_g_loss_matches_jax(gan_type):
    ja, state, ta = _pair(gan_type)
    fake, real, scales = _batch(2)

    def jf(f):
        return ja.g_loss(state, f, jnp.asarray(real), jnp.asarray(scales))

    want, jgrad = jax.jit(jax.value_and_grad(jf))(jnp.asarray(fake))
    f = torch.from_numpy(fake).requires_grad_(True)
    got = ta.generator_loss(f, torch.from_numpy(real),
                            {"sr_scales": torch.from_numpy(scales)})
    (tgrad,) = torch.autograd.grad(got, f)
    _close(float(got), float(want))
    _close(tgrad.numpy(), np.asarray(jgrad))
