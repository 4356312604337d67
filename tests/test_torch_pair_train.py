"""The train-pair kernel's plain version (``kernels.pair_train``) and its
``torch.autograd`` gradient against the JAX kernel on the CPU.

* At c = 12, 2 heads, window 4 (as ``tests/test_pair_train.py``), shift
  0 and 2, with and without stochastic-depth factor columns (the same
  columns on both sides), under 'clamp', 'stable' and 'stable_mm': the
  output against
  ``fused_swin_pair_train(interpret=True)`` and every gradient (tokens,
  the two 12-param bundles, both biases) against ``jax.grad`` of it.
* At the E1 width C = 60, 6 heads, window 8 on one 24x24 image: the same
  against ``jax.grad`` of ``_pair_ops`` (the kernel's body on arrays).
* Bars: output 1e-2, gradients 2e-2, relative to the reference's max.
* The layer route (``BasicLayer._train_pairs``) against the JAX layer
  with ``pallas_train='pair'``; route decisions at build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import pair_train as jpt
from rdst_tpu.kernels.swin_block import (head_mask_arr, pack_bias_fast,
                                         prep_block_params, seg_ones_arr)
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import pair_train as pt
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import set_train_mode

OUT_TOL, GRAD_TOL = 1e-2, 2e-2
JAX_SOFTMAX = {"clamp": "clamp", "stable": "stable", "stable_mm": "stable_mm"}


def _params(rng, c, hid):
    def arr(*s, scale=0.5):
        return rng.normal(0, scale, s).astype(np.float32)

    return [arr(c, 3 * c, scale=c ** -0.5), arr(3 * c, scale=0.1),
            arr(c, c, scale=c ** -0.5), arr(c, scale=0.1),
            1 + 0.1 * arr(c), 0.1 * arr(c), 1 + 0.1 * arr(c), 0.1 * arr(c),
            arr(c, hid, scale=c ** -0.5), arr(hid, scale=0.1),
            arr(hid, c, scale=hid ** -0.5), arr(c, scale=0.1)]


def _case(seed, c, nh, ws, h, w, images, shift, with_dpf):
    rng = np.random.default_rng(seed)
    n, nw = ws * ws, (h // ws) * (w // ws)
    pa, pb = _params(rng, c, 2 * c), _params(rng, c, 2 * c)
    bias_a = rng.normal(0, 0.1, (nh, n, n)).astype(np.float32)
    bias_b = rng.normal(0, 0.1, ((nh * nw if shift else nh), n, n)
                        ).astype(np.float32)
    x = np.asarray(jnp.asarray(rng.normal(0, 0.5, (images * nw, n, c)),
                               jnp.bfloat16).astype(jnp.float32))
    dpf = None
    if with_dpf:
        f = rng.choice([0.0, 1 / 0.9], (images, 4)).astype(np.float32)
        dpf = np.repeat(f, nw * n, axis=0)
    wout = rng.normal(0, 1, (images * nw, n, c)).astype(np.float32)
    return dict(x=x, pa=pa, pb=pb, bias_a=bias_a, bias_b=bias_b, dpf=dpf,
                wout=wout, nh=nh, ws=ws, size=(h, w), shift=shift)


def _torch_side(cs, softmax):
    x = torch.from_numpy(cs["x"]).to(torch.bfloat16).requires_grad_(True)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in cs["pa"] + [cs["bias_a"]] + cs["pb"] + [cs["bias_b"]]]
    dpf = None if cs["dpf"] is None else torch.from_numpy(cs["dpf"])
    y = pt.fused_swin_pair_train(
        x, leaves[:12], leaves[12], leaves[13:25], leaves[25], dpf,
        num_heads=cs["nh"], x_size=cs["size"], window_size=cs["ws"],
        shift=cs["shift"], softmax=softmax)
    (y.float() * torch.from_numpy(cs["wout"])).sum().backward()
    grads = [x.grad.float().numpy()] + [t.grad.numpy() for t in leaves]
    return y.float().detach().numpy(), grads


def _jax_side(cs, softmax, monkeypatch, kernel: bool):
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", JAX_SOFTMAX[softmax])
    clear_kernel_caches()
    nh, ws, (h, w), shift = cs["nh"], cs["ws"], cs["size"], cs["shift"]
    c, n = cs["x"].shape[-1], ws * ws
    nwh, nww = h // ws, w // ws
    nw, bnw = nwh * nww, cs["x"].shape[0]
    dt = jnp.bfloat16
    dpf = None if cs["dpf"] is None else jnp.asarray(cs["dpf"])
    wout = jnp.asarray(cs["wout"])

    def kern(x, pa, bias_a, pb, bias_b):
        return jpt.fused_swin_pair_train(
            x, pa, bias_a, pb, bias_b, dpf, num_heads=nh, x_size=(h, w),
            window_size=ws, shift=shift, images_per_program=1,
            interpret=True)

    def oracle(x, pa, bias_a, pb, bias_b):
        fa = tuple(prep_block_params(list(pa), c, nh, dt))
        fb = tuple(prep_block_params(list(pb), c, nh, dt))
        ba = pack_bias_fast(bias_a, nh, n, dt)
        bb = pack_bias_fast(bias_b, nh, n, dt)
        xg = x.reshape(bnw // nw, nw * n, c)
        dg = None if dpf is None else dpf.reshape(bnw // nw, nw * n, 4)
        outs = [jpt._pair_ops(
            xg[i].astype(jnp.float32), dt, nh, nw, n, c, nw,
            (1, nwh, nww, ws, shift), fa, ba, fb, bb,
            head_mask_arr(nh, c, dt), seg_ones_arr(nh, n, dt),
            None if dg is None else dg[i]).astype(dt)
            for i in range(xg.shape[0])]
        return jnp.stack(outs).reshape(bnw, n, c)

    fn = kern if kernel else oracle

    def loss(*args):
        return jnp.sum(fn(*args).astype(jnp.float32) * wout)

    args = (jnp.asarray(cs["x"], dt), [jnp.asarray(a) for a in cs["pa"]],
            jnp.asarray(cs["bias_a"]), [jnp.asarray(a) for a in cs["pb"]],
            jnp.asarray(cs["bias_b"]))
    y = np.asarray(fn(*args), np.float32)
    g = jax.grad(loss, argnums=tuple(range(5)))(*args)
    grads = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(g)]
    return y, grads


def _compare(got, want):
    y, gs = got
    y_ref, gs_ref = want
    assert float(np.abs(y - y_ref).max()) <= OUT_TOL * np.abs(y_ref).max()
    assert len(gs) == len(gs_ref) == 27
    for i, (a, b) in enumerate(zip(gs, gs_ref)):
        denom = max(1e-6, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) / denom <= GRAD_TOL, i


@pytest.mark.parametrize("softmax", ["clamp", "stable", "stable_mm"])
@pytest.mark.parametrize("shift,with_dpf", [(0, False), (2, False),
                                            (2, True)])
def test_twin_matches_jax_kernel(monkeypatch, softmax, shift, with_dpf):
    cs = _case(0, 12, 2, 4, 8, 8, 4, shift, with_dpf)
    _compare(_torch_side(cs, softmax),
             _jax_side(cs, softmax, monkeypatch, kernel=True))


@pytest.mark.parametrize("softmax", ["clamp", "stable"])
def test_twin_matches_jax_at_e1_width(monkeypatch, softmax):
    cs = _case(1, 60, 6, 8, 24, 24, 1, 4, True)
    _compare(_torch_side(cs, softmax),
             _jax_side(cs, softmax, monkeypatch, kernel=False))


def test_wrapper_refuses_geometry():
    c, hid = 132, 264  # the bf16 window body takes C <= 128
    rng = np.random.default_rng(0)
    fp = pt.fast_params([torch.from_numpy(a) for a in _params(rng, c, hid)],
                        c, 6)
    bias = torch.zeros(1, 64, 6 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pallas_train='off'"):
        pt.run_pair_train(torch.zeros(9, 64, c, dtype=torch.bfloat16), fp,
                          bias, fp, bias.expand(9, -1, -1), num_heads=6,
                          x_size=(24, 24), window_size=8, shift=4)


def _tiny(**kw):
    p = ParametersLoader("config_files/rdst_tiny_oasis_x4.ini")
    for k, v in kw.items():
        p.set(k, v)
    return p


def test_route_decisions_at_build():
    """Routes are decided once, at build: 'pair' where the JAX package's
    rule admits the pair, 'block' (the single-block train kernel, the
    JAX package's forced A/B) for every block; a layer that no train
    kernel takes raises, naming pallas_train='off'."""
    model = build_generator(_tiny(rdst_growth_rate=6), dtype=torch.bfloat16)
    assert set_train_mode(model, "pair") == "pair"
    assert model.train_routes == {"pair": 4, "block": 0}
    assert set_train_mode(model, "") == ""
    assert set_train_mode(model, "block") == "block"
    assert model.train_routes == {"pair": 0, "block": 8}
    f32 = build_generator(_tiny(rdst_growth_rate=6))
    assert set_train_mode(f32, "pair") == ""  # f32 trains on autograd
    dropped = build_generator(_tiny(rdst_growth_rate=6, swin_drop_rate=0.1),
                              dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pallas_train='off'"):
        set_train_mode(dropped, "pair")
    assert set_train_mode(dropped, "") == ""
    # head dim 33: past what either train kernel takes
    wide = build_generator(_tiny(rdst_embed_dim=198, rdst_growth_rate=6,
                                 rdst_num_heads=[6, 6], pallas_kernels="off"),
                           dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pallas_train='off'"):
        set_train_mode(wide, "pair")


def test_serving_route_refuses_grad():
    model = build_generator(_tiny(rdst_growth_rate=6), dtype=torch.bfloat16)
    x = torch.rand(1, 8, 8, 1)
    with pytest.raises(RuntimeError, match="without a gradient"):
        model(x)
    with torch.no_grad():
        assert torch.isfinite(model(x).float()).all()


@pytest.mark.parametrize("route", ["pair", "plain"])
def test_layer_drop_path_is_seeded_and_stochastic(route):
    """A BasicLayer with stochastic depth (as ``tests/test_pair_train.py``
    drives the JAX one): in training mode the factor columns (pair
    route) or the DropPath modules (plain route) draw from the explicit
    generator: the same seed gives the same output, another seed another
    one, and the gradients stay finite; eval mode draws nothing."""
    from rdst_tpu_torch.nn.layers import set_generator
    from rdst_tpu_torch.nn.swin import BasicLayer

    layer = BasicLayer(12, 2, 3, 8, mlp_ratio=2.0, build_resolution=(16, 16),
                       drop_path=(0.5, 0.5))
    layer.use_pair_train = route == "pair"
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 256, 12)).astype(np.float32)).to(torch.bfloat16)

    def run(seed):
        set_generator(layer, torch.Generator().manual_seed(seed))
        layer.train()
        y = layer(x, (16, 16))
        loss = (y.float() ** 2).mean()
        grads = torch.autograd.grad(loss, list(layer.parameters()),
                                    allow_unused=True)
        return float(loss), grads

    a, ga = run(1)
    b, _ = run(1)
    c, _ = run(2)
    assert a == b and a != c
    assert all(torch.isfinite(g).all() for g in ga if g is not None)
    layer.eval()
    with torch.no_grad():
        set_generator(layer, torch.Generator().manual_seed(3))
        e1 = layer.blocks[0](x, (16, 16))
        set_generator(layer, torch.Generator().manual_seed(4))
        e2 = layer.blocks[0](x, (16, 16))
    assert torch.equal(e1, e2)
