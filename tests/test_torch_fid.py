"""The port's FID and VGG losses against ``rdst_tpu``'s on the CPU:

* ``frechet_distance`` (float64 ``eigh`` of the symmetric form) against
  the JAX function (``scipy.linalg.sqrtm``) on random positive
  semidefinite moments, a singular one included: relative 1e-6; nan on
  non-finite moments, as the JAX function returns it;
* FID end to end with the committed VGG substitute and with the random
  projection, on the same 1- and 3-channel images: relative 1e-4;
* InceptionV3 pool3 features with random weights carried from a JAX
  variables tree (``checkpoint.convert.export_flax_tree``): 1e-4; its
  299x299 linear resize against ``resize_nhwc``; with a weights file
  named by ``RDST_TPU_INCEPTION_PT`` the FID scores by that network;
* ``VGGLoss`` (``VGG54``, ``VGG22``, and a 2-channel input scored channel
  by channel) and its gradient: 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rdst_tpu.losses.vgg import VGGLoss as JaxVGGLoss
from rdst_tpu.metrics import fid as jfid
from rdst_tpu.metrics.inception import InceptionV3Pool3 as JaxInception
from rdst_tpu_torch.checkpoint.convert import export_flax_tree, import_flax_tree
from rdst_tpu_torch.losses.vgg import VGGLoss
from rdst_tpu_torch.metrics import fid as tfid
from rdst_tpu_torch.metrics.inception import (InceptionFeatures,
                                              InceptionV3Pool3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for torch: the suite runs six workers on the
    CPU, and each worker's default of one thread per core oversubscribes
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def _moments(rng, d, n):
    a = rng.normal(0, 1, (n, d))
    return rng.normal(0, 1, d), np.cov(a, rowvar=False)


@pytest.mark.parametrize("d,n1,n2", [(6, 40, 50), (16, 9, 30), (32, 12, 12)])
def test_frechet_distance_matches_jax(d, n1, n2):
    """n <= d makes the covariance singular (rank n - 1)."""
    rng = np.random.default_rng(d)
    mu1, s1 = _moments(rng, d, n1)
    mu2, s2 = _moments(rng, d, n2)
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    assert _rel(tfid.frechet_distance(mu1, s1, mu2, s2), want) <= 1e-6
    assert abs(tfid.frechet_distance(mu1, s1, mu1, s1)) <= 1e-6 * np.trace(s1)


def test_frechet_distance_nan_on_non_finite():
    s = np.eye(3)
    with pytest.warns(UserWarning):
        assert np.isnan(tfid.frechet_distance(np.zeros(3), s * np.nan,
                                              np.zeros(3), s))


def _image_sets(c, n=16, hw=(32, 36)):
    rng = np.random.default_rng(c)
    gts = [rng.random(hw + (c,), dtype=np.float32) for _ in range(n)]
    preds = [np.clip(g + rng.normal(0, 0.1, g.shape), 0, 1).astype(np.float32)
             for g in gts]
    return gts, preds


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("extractor", ["vgg", "random"])
def test_fid_matches_jax(extractor, c):
    jf, tf = jfid.FID(), tfid.FID(gpu_id=-1)
    assert isinstance(jf.extractor, jfid._NativeVGGFeatures)
    assert isinstance(tf._extractor(), tfid.NativeVGGFeatures)
    if extractor == "random":
        jf.extractor = jfid._RandomProjectionFeatures()
        tf.extractor = tfid.RandomProjectionFeatures()
    gts, preds = _image_sets(c)
    want = jf(gts, preds)
    got = tf(gts, preds)
    assert np.isfinite(want) and want > 0
    assert _rel(got, want) <= 1e-4, (got, want)


def _random_inception_variables(seed=0):
    """A random JAX variables tree of ``InceptionV3Pool3`` (numpy), made
    on its layout through a template module."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for n, t in InceptionV3Pool3().state_dict().items():
        if n.endswith(("running_mean", "bn.bias")):
            v = 0.2 * torch.randn(t.shape, generator=g)
        elif n.endswith(("running_var", "bn.weight")):
            v = 0.75 + 0.5 * torch.rand(t.shape, generator=g)
        else:
            v = torch.randn(t.shape, generator=g) / np.sqrt(t[0].numel())
        sd[n] = v
    return import_flax_tree(sd)


@pytest.fixture(scope="module")
def inception_pair():
    variables = _random_inception_variables()
    tm = InceptionV3Pool3()
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in export_flax_tree(variables).items()})
    return variables, tm.eval()


def test_inception_features_match_jax(inception_pair):
    variables, tm = inception_pair
    x = np.random.default_rng(0).random((2, 80, 88, 3), dtype=np.float32)
    want = np.asarray(jax.jit(JaxInception().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048)
    assert float(np.abs(got - want).max()) <= 1e-4


def test_inception_resize_matches_jax():
    from rdst_tpu.data.ops_jax import resize_nhwc

    x = np.random.default_rng(1).random((2, 40, 36, 3), dtype=np.float32)
    want = np.asarray(resize_nhwc(jnp.asarray(x), (299, 299), "linear"))
    got = InceptionFeatures(InceptionV3Pool3())._resize(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5


def test_fid_scores_by_inception_when_weights_exist(inception_pair, tmp_path,
                                                    monkeypatch):
    """The weights file is read as pytorch-fid's state dict (the network
    above) and the extractor scores a 1-channel image on 299x299."""
    _, tm = inception_pair
    path = tmp_path / "pt_inception.pth"
    torch.save(tm.state_dict(), path)
    monkeypatch.setenv("RDST_TPU_INCEPTION_PT", str(path))
    ext = tfid.FID(gpu_id=-1, batch_size=2)._extractor()
    assert isinstance(ext, InceptionFeatures)
    for k, v in tm.state_dict().items():
        assert torch.equal(ext.model.state_dict()[k], v), k
    imgs, _ = _image_sets(1, n=1, hw=(24, 28))
    feats = ext(imgs)
    assert feats.shape == (1, 2048) and np.isfinite(feats).all()


@pytest.mark.parametrize("name,c", [("VGG54", 1), ("VGG22", 1), ("VGG54", 2)])
def test_vgg_loss_matches_jax(name, c):
    rng = np.random.default_rng(c)
    pred = rng.random((2, 32, 32, c), dtype=np.float32)
    target = rng.random((2, 32, 32, c), dtype=np.float32)
    jl, tl = JaxVGGLoss(name), VGGLoss(name)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jl(p, jnp.asarray(target))))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tl(p, torch.from_numpy(target))
    (tgrad,) = torch.autograd.grad(got, p)
    assert _rel(float(got), float(want)) <= 1e-5
    assert float((tgrad - torch.from_numpy(np.asarray(jgrad))).abs().max()) \
        <= 1e-5 * float(np.abs(np.asarray(jgrad)).max())
    assert not any(q.requires_grad for q in tl.parameters())
