"""The port's segmentation UNet and its perceptual loss against
``rdst_tpu``'s on the CPU, with the committed full-width ``SegUNet(1, 4)``
(``weights/unet_tiny.pkl``, the JAX package's variables as numpy):

* features (the six encoder stages), decoder output and logits at 32x32
  and at 40x36, which reflect-pads to 64x64 and crops back: 1e-4 absolute;
* ``SegUNetLoss`` in each mode (``encoder-L1`` with two stages, which
  divides inside its loop; ``encoder-L2``; ``decoder-L1``; ``label-hr``;
  ``label-gt`` on labels): 1e-5; the gradient with respect to the
  prediction (through the encoder, and through encoder, decoder and head
  in ``label-gt``): 1e-5; no gradient reaches the UNet's weights;
* ``dice_loss`` on every class and on the lesion classes: 1e-5;
* without a checkpoint the loss warns and draws its UNet from the
  port's own seeded generator (a difference by design from the JAX
  package's ``PRNGKey(0)`` UNet).
"""

import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.losses.seg_unet import SegUNetLoss as JaxSegLoss
from rdst_tpu.losses.seg_unet import dice_loss as jax_dice
from rdst_tpu.models.seg_unet import SegUNet as JaxSegUNet
from rdst_tpu_torch.checkpoint.convert import export_flax_tree
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.losses.seg_unet import SegUNetLoss, dice_loss
from rdst_tpu_torch.models.seg_unet import SegUNet

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
UNET = str(REPO / "weights" / "unet_tiny.pkl")


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
def variables():
    with open(UNET, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_unet(variables):
    m = SegUNet(1, 4)
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in export_flax_tree(variables).items()})
    return m.eval()


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _loss_inputs():
    rng = np.random.default_rng(1)
    pred = rng.random((2, 32, 32, 1), dtype=np.float32)
    target = rng.random((2, 32, 32, 1), dtype=np.float32)
    labels = rng.integers(0, 4, (2, 32, 32, 1)).astype(np.int32)
    return pred, target, labels


@pytest.fixture(scope="module")
def jax_unet_32(variables):
    """The JAX UNet's (features, decoder, logits) of the loss inputs'
    prediction and target, in one compiled call."""
    pred, target, _ = _loss_inputs()
    out = jax.jit(JaxSegUNet(1, 4).apply)(
        variables, jnp.asarray(np.concatenate([pred, target])))
    return {key: jax.tree.map(lambda a, i=i: a[2 * i:2 * i + 2], out)
            for i, key in enumerate(("pred", "target"))}


@pytest.mark.parametrize("hw", [(32, 32), (40, 36)])
def test_seg_unet_matches_jax(variables, port_unet, jax_unet_32, hw):
    if hw == (32, 32):
        x = _loss_inputs()[0]
        feats, dec, logits = jax_unet_32["pred"]
    else:
        x = np.random.default_rng(0).random((2,) + hw + (1,),
                                            dtype=np.float32)
        feats, dec, logits = jax.jit(JaxSegUNet(1, 4).apply)(
            variables, jnp.asarray(x))
    with torch.no_grad():
        tf, td, tl = port_unet(torch.from_numpy(x))
    assert len(tf) == len(feats) == 6
    for got, want in zip(tf, feats):
        assert float(np.abs(got.numpy() - _nchw(want)).max()) <= 1e-4
    assert td.shape[2:] == tl.shape[2:] == hw
    assert float(np.abs(td.numpy() - _nchw(dec)).max()) <= 1e-4
    assert float(np.abs(tl.numpy() - _nchw(logits)).max()) <= 1e-4


def _paras(cls, layers, mode="OASIS_lesion_only"):
    p = cls(TINY)
    p.set("unet_loss_layers", layers)
    p.set("unet_loss_mode", mode)
    p.set("unet_native_ckpt", UNET)
    return p


GRAD_MODES = ({"encoder-L1": [1, 2]}, {"label-gt": [0]})


@pytest.fixture(scope="module")
def jax_seg_grads(variables):
    """The JAX loss and its gradient through the JAX UNet for each of
    GRAD_MODES, in one compiled call."""
    pred, target, labels = _loss_inputs()
    losses = [JaxSegLoss(_paras(JaxParams, layers), variables)
              for layers in GRAD_MODES]

    def all_modes(p):
        return [jax.value_and_grad(lambda q, jl=jl: jl(
            q, jnp.asarray(target), {"seg_gt": jnp.asarray(labels)}))(p)
            for jl in losses]

    return jax.jit(all_modes)(jnp.asarray(pred))


@pytest.mark.parametrize("layers,grad", [
    (GRAD_MODES[0], True), ({"encoder-L2": [1]}, False),
    ({"decoder-L1": [0]}, False), ({"label-hr": [0]}, False),
    (GRAD_MODES[1], True)])
def test_seg_loss_matches_jax(variables, jax_unet_32, jax_seg_grads, layers,
                              grad):
    """The value-only modes run the JAX loss on the JAX UNet's outputs of
    one compiled call (``jax_unet_32``); the gradient modes differentiate
    the JAX loss through the JAX UNet (``jax_seg_grads``)."""
    pred, target, labels = _loss_inputs()
    jl = JaxSegLoss(_paras(JaxParams, layers), variables)
    tl = SegUNetLoss(_paras(ParametersLoader, layers), variables)

    def f(p):
        return jl(p, jnp.asarray(target), {"seg_gt": jnp.asarray(labels)})

    p = torch.from_numpy(pred).requires_grad_(True)
    got = tl(p, torch.from_numpy(target),
             {"seg_gt": torch.from_numpy(labels)})
    assert not any(q.requires_grad for q in tl.parameters())
    if not grad:
        jl._unet = lambda x: jax_unet_32[
            "pred" if np.array_equal(np.asarray(x), pred) else "target"]
        want = f(jnp.asarray(pred))
        assert abs(float(got) - float(want)) <= 1e-5 * max(1.0,
                                                          abs(float(want)))
        return
    want, jgrad = jax_seg_grads[GRAD_MODES.index(layers)]
    (tgrad,) = torch.autograd.grad(got, p)
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    jgrad = np.asarray(jgrad)
    assert float(np.abs(tgrad.numpy() - jgrad).max()) <= \
        1e-5 * max(1e-3, float(np.abs(jgrad).max()))


@pytest.mark.parametrize("classes", [[0, 1, 2, 3], [1, 2, 3]])
def test_dice_loss_matches_jax(classes):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (2, 12, 10, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 12, 10))
    want = float(jax_dice(jnp.asarray(logits), jnp.asarray(labels), classes))
    got = float(dice_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                          torch.from_numpy(labels), classes))
    assert abs(got - want) <= 1e-5


def test_random_unet_without_a_checkpoint_warns():
    p = _paras(ParametersLoader, {"encoder-L1": [1]})
    p.set("unet_native_ckpt", None)
    with pytest.warns(UserWarning, match="random-initialized"):
        a = SegUNetLoss(p)
    # seeded: the first convolution holds the first draws of seed 0
    w = a.model.encoder.conv1.weight
    u = torch.rand(w.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, (2 * u - 1) * w[0].numel() ** -0.5)
    x = torch.rand(1, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    assert float(a(x, x.flip(1))) > 0
