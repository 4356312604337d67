"""The port's VGG19 feature stack (``rdst_tpu_torch.losses.vgg``) and
``lpips`` metric (``rdst_tpu_torch.metrics.perceptual``) against the JAX
package's on the CPU, with the committed native feature stack
(``weights/vgg19_features_native.pkl``): the features at the VGG-loss
taps within 1e-4 relative max, the distance within 1e-5 relative (both
run their convolutions in float32, XLA's and oneDNN's in their own
summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.losses import vgg as jax_vgg
from rdst_tpu.metrics import perceptual as jax_perceptual
from rdst_tpu_torch.losses import vgg
from rdst_tpu_torch.metrics import perceptual
from rdst_tpu_torch.metrics.image_metrics import METRIC_FUNCS


@pytest.mark.parametrize("tap", [8, 35])
def test_feature_stack_matches_jax(tap):
    variables, width = vgg.load_native_features(tap)
    jvars, jwidth = jax_vgg.load_native_features(tap)
    assert width == jwidth == 0.25 and set(variables["params"]) == set(
        jvars["params"])
    x = np.random.default_rng(tap).random((2, 32, 48, 3), dtype=np.float32)
    want = np.asarray(jax_vgg.VGG19Features(tap=tap, width=jwidth).apply(
        jvars, jnp.asarray(x)))
    net = vgg.VGG19Features(tap, width).load_variables(variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("shape", [(40, 32, 1), (37, 21, 1), (24, 20, 4),
                                   (33, 17), (32, 32, 3)])
def test_lpips_matches_jax(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    gt = rng.random(shape, dtype=np.float32)
    p = np.clip(gt + 0.1 * rng.standard_normal(shape).astype(np.float32),
                0, 1)
    got, want = perceptual.lpips(gt, p), jax_perceptual.lpips(gt, p)
    assert got > 0
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert perceptual.lpips(gt, gt) == 0.0
    assert METRIC_FUNCS["lpips"](gt, p) == got


def test_lpips_backbone_is_the_native_stack():
    net = perceptual._backbone()
    assert net.width == 0.25 and len(net.convs) == 16 and not net.training
    assert all(not p.is_cuda for p in net.parameters())
    assert jax.devices()[0].platform == "cpu"
