"""The port's utilities against the JAX package's on the CPU:
``utils.flops`` (parameter counts, the FLOP CLI), ``utils.profiling``
(``Throughput``, ``time_fn``, ``trace``) and ``losses.patchgan``
(PatchGAN, GANLoss, the gradient penalty).

* ``count_params`` equals the JAX ``count_params`` exactly for E1 and
  SwinIR-std;
* ``python -m rdst_tpu_torch.utils.flops`` prints the JAX CLI's keys for
  ``rdst_tiny_oasis_x4.ini`` (no byte figure: ``null``), the same
  parameter count, ``grad_flops > forward_flops``, and a forward count
  within 1% of an analytic count of the config's convolutions, dense
  layers and window-attention products;
* ``Throughput`` and ``time_fn`` behave as ``tests/test_aux.py`` holds
  the JAX ones; ``trace`` writes a Chrome trace;
* PatchGAN on weights carried from the JAX module, GANLoss in its three
  modes and the gradient penalty within 1e-4 of the JAX package.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.utils import flops as jax_flops
from rdst_tpu_torch.checkpoint.convert import (export_flax_tree,
                                               import_flax_tree)
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.losses import patchgan
from rdst_tpu_torch.utils import flops, profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
TOL = 1e-4


@pytest.mark.parametrize("config", ["rdst_e1_40k_oasis20_x4",
                                    "swinir_std_40k_oasis20_x4"])
def test_count_params_matches_jax(config):
    path = str(REPO / "config_files" / f"{config}.ini")
    jp = JaxParams(path)
    model = jax_build(jp)
    x = jnp.zeros((1, jp.patch_size, jp.patch_size, jp.input_channel))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                               4.0))
    want = jax_flops.count_params(shapes["params"])
    assert flops.count_params(flops.plain_model(ParametersLoader(path))) \
        == want


def _analytic_flops(model, x, scale) -> float:
    """Two operations a multiply-add of every convolution, dense layer and
    window-attention product (``q k^T`` and ``attn v``), from each
    module's output shape."""
    from rdst_tpu_torch.nn.swin import WindowAttention

    total = [0.0]

    def conv(m, args, out):
        total[0] += 2.0 * out.numel() * m.weight[0].numel()

    def dense(m, args, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def attention(m, args, out):
        b_, n, c = args[0].shape
        total[0] += 2.0 * 2 * b_ * n * n * c

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(dense))
        elif isinstance(m, WindowAttention):
            hooks.append(m.register_forward_hook(attention))
    with torch.no_grad():
        model(x, scale)
    for h in hooks:
        h.remove()
    return total[0]


def test_flops_cli_matches_jax_keys(capsys):
    argv = ["--config-file", TINY, "--batch", "1", "--lr-hw", "16", "16",
            "--grad"]
    jax_flops.main(argv + ["--platform", "cpu"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    flops.main(argv)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    assert got["params"] == want["params"] and got["model"] == "rdst"
    assert got["lr_shape"] == want["lr_shape"] == [1, 16, 16, 1]
    assert got["forward_bytes"] is None and got["grad_bytes"] is None
    assert got["grad_flops"] > got["forward_flops"] > 1e8
    # the counter's forward against an analytic count at the same shape
    model = flops.plain_model(ParametersLoader(TINY))
    analytic = _analytic_flops(model, torch.zeros(1, 16, 16, 1), 4.0)
    assert abs(got["forward_flops"] - analytic) <= 0.01 * analytic


def test_model_summary_and_count_flops():
    model = flops.plain_model(ParametersLoader(TINY))
    x = torch.zeros(1, 8, 8, 1)
    with torch.no_grad():
        total, by_op = flops.count_flops(model, x, 4.0)
    assert total == sum(by_op.values()) > 1e6
    assert any("convolution" in k for k in by_op)
    line = flops.model_summary(model, x, 4.0)
    assert "params" in line and "GFLOPs @ (1, 8, 8, 1)" in line


def test_throughput_counter():
    t = profiling.Throughput(warmup_steps=1)
    for _ in range(3):
        t.step(10)
    rep = t.report()
    assert rep["steps"] == 3 and rep["items_per_sec"] > 0
    assert rep["steps_per_sec"] > 0
    assert profiling.Throughput(warmup_steps=0).warmup_steps == 1


def test_time_fn_and_trace(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    x = torch.ones(64, 64)
    t = profiling.time_fn(fn, x, iters=5, warmup=2)
    assert t > 0 and len(calls) == 1 + 2 + 5
    with profiling.trace(str(tmp_path / "trace")):
        fn(x)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.fixture(scope="module")
def patchgan_pair():
    """The JAX PatchGAN's variables at ndf 8, n_layers 3 on (2, 32, 32, 1)
    pairs, and the port's PatchGAN with them carried across."""
    from rdst_tpu.losses.patchgan import PatchGAN as JaxPatchGAN

    rng = np.random.default_rng(0)
    a = rng.random((2, 32, 32, 1), dtype=np.float32)
    b = rng.random((2, 32, 32, 1), dtype=np.float32)
    jd = JaxPatchGAN(ndf=8, n_layers=3)
    variables = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(a),
                                                 jnp.asarray(b)))
    td = patchgan.PatchGAN(in_channels=2, ndf=8, n_layers=3)
    td.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        export_flax_tree(variables).items()})
    return jd, variables, td, a, b


def test_patchgan_matches_jax(patchgan_pair):
    jd, variables, td, a, b = patchgan_pair
    want = np.asarray(jd.apply(variables, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = td(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    back = import_flax_tree(td.state_dict())
    for k, v in jax.tree_util.tree_leaves_with_path(variables["params"]):
        path = [p.key for p in k]
        node = back["params"]
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node, v)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
def test_gan_loss_matches_jax(mode):
    from rdst_tpu.losses.patchgan import GANLoss as JaxGANLoss

    pred = np.random.default_rng(1).normal(size=(2, 2, 2, 1)).astype(
        np.float32)
    for real in (True, False):
        want = float(JaxGANLoss(mode)(jnp.asarray(pred), real))
        got = float(patchgan.GANLoss(mode)(torch.from_numpy(pred), real))
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (mode, real)
    with pytest.raises(ValueError):
        patchgan.GANLoss("hinge")


@pytest.mark.parametrize("mode", ["mixed", "real", "fake"])
def test_gradient_penalty_matches_jax(patchgan_pair, mode):
    from rdst_tpu.losses.patchgan import gradient_penalty as jax_gp

    jd, variables, td, a, b = patchgan_pair
    key = jax.random.PRNGKey(5)
    cond = jnp.asarray(a)
    want = float(jax_gp(lambda h: jd.apply(variables, cond, h),
                        jnp.asarray(a), jnp.asarray(b), key, mode=mode))
    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (2, 1, 1, 1))))
    tcond = torch.from_numpy(a)
    got = patchgan.gradient_penalty(lambda h: td(tcond, h),
                                    torch.from_numpy(a), torch.from_numpy(b),
                                    mode=mode, alpha=alpha)
    assert abs(float(got.detach()) - want) <= TOL * max(1.0, abs(want))
    assert got.requires_grad  # differentiable in the discriminator
    grads = torch.autograd.grad(got, list(td.parameters()), allow_unused=True)
    assert all(torch.isfinite(g).all() for g in grads if g is not None)
    assert sum(g is not None for g in grads) >= 5
