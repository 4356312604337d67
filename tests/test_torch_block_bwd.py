"""The staged plain VJP of the training block (``kernels.block_train
.block_bwd_reference``, the CPU oracle of the CUDA backward's phases in
``csrc/block_bwd.cuh``) against ``torch.autograd`` of the plain version
and against the JAX kernel's VJP, on the CPU.

* At C = 12, 2 heads, window 4 (N = 16), 2 images of 8x8 (4 windows
  each): shared and per-window bias, with and without stochastic-depth
  factor columns, under 'clamp', 'stable' and 'stable_mm'; a case with
  scores past the clamp; cases with ties in the row max (q zeroed, the
  bias on a grid of three values, so every row's max is shared). The
  staged VJP's folded gradients are carried back through the fold by
  autograd of ``fast_params``/``pack_bias_fast`` (as the card's
  ``BlockTrainFunction`` does) and compared, with dx, against
  ``jax.grad`` of ``rdst_tpu.kernels.block_train.fused_swin_block_train
  (interpret=True)``; the folded gradients themselves against autograd of
  ``block_train_reference``.
* At SwinIR-std's width C = 180, 6 heads, window 8, one 24x24 image.
* The DSTL pair: two staged VJPs chained through the relayout (block b's
  input cotangent unshifted back into block a's output cotangent)
  against autograd of ``pair_train_reference``.
* Bar: every gradient within 2e-2 of the reference's max (the bar of
  ``test_torch_block_train.py``): both sides round to bf16 at the same
  places, so they differ by bf16 roundings that land the other way after
  f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import block_train as jbt
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu_torch.kernels import block_train as bt
from rdst_tpu_torch.kernels import pair_train as pt
from rdst_tpu_torch.kernels.swin_block import (BF16, FastParams, fast_params,
                                               pack_bias_fast)
from rdst_tpu_torch.kernels.swin_pair import shift_relayout, unshift_relayout

GRAD_TOL = 2e-2


def _params(rng, c, hid, zero_q=False):
    def arr(*s, scale=0.5):
        return rng.normal(0, scale, s).astype(np.float32)

    p = [arr(c, 3 * c, scale=c ** -0.5), arr(3 * c, scale=0.1),
         arr(c, c, scale=c ** -0.5), arr(c, scale=0.1),
         1 + 0.1 * arr(c), 0.1 * arr(c), 1 + 0.1 * arr(c), 0.1 * arr(c),
         arr(c, hid, scale=c ** -0.5), arr(hid, scale=0.1),
         arr(hid, c, scale=hid ** -0.5), arr(c, scale=0.1)]
    if zero_q:  # q = 0: the scores are the bias alone
        p[0][:, :c] = 0.0
        p[1][:c] = 0.0
    return p


def _case(seed, c, nh, ws, nw, images, per_window, with_dpf, scores=""):
    rng = np.random.default_rng(seed)
    n = ws * ws
    shape = ((nh * nw if per_window else nh), n, n)
    if scores == "ties":  # three values: each row's max is shared
        bias = rng.integers(0, 3, shape).astype(np.float32)
    elif scores == "over60":  # some scores past the clamp, clear of its
        # edge (the clamp's gradient jumps there)
        bias = np.where(rng.random(shape) < 0.1, 80.0 + rng.random(shape),
                        rng.normal(0, 0.5, shape)).astype(np.float32)
    else:
        bias = rng.normal(0, 0.5, shape).astype(np.float32)
    x = rng.normal(0, 0.5, (images * nw, n, c)).astype(np.float32)
    dpf = None
    if with_dpf:
        f = np.array([[0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9],
                      [1 / 0.9, 0.0]], np.float32)[:images]
        dpf = np.repeat(f, nw * n, axis=0)
    dz = rng.normal(0, 1, (images * nw, n, c)).astype(np.float32)
    return dict(x=x, p=_params(rng, c, 2 * c, scores == "ties"), bias=bias,
                dpf=dpf, dz=dz, nh=nh, nw=nw)


def _bf(a):
    return torch.from_numpy(a).to(BF16)


def _staged(cs, softmax):
    """dx, the folded gradients, dbias, and the raw gradients (x, the 12
    params, the head-major bias) through the fold."""
    nh = cs["nh"]
    x, dz = _bf(cs["x"]), _bf(cs["dz"])
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in cs["p"] + [cs["bias"]]]
    c = x.shape[-1]
    fp = fast_params(leaves[:12], c, nh)
    pb = pack_bias_fast(leaves[12].to(BF16), nh, x.shape[1])
    dpf = None if cs["dpf"] is None else torch.from_numpy(cs["dpf"])
    dx, g, db = bt.block_bwd_reference(
        x, dz, FastParams(*[a.detach() for a in fp]), pb.detach(), dpf,
        num_heads=nh, softmax=softmax)
    assert dx.dtype == BF16 and db.shape == pb.shape
    assert all(a.shape == b.shape for a, b in zip(g, fp))
    # the card's BlockTrainFunction: grads cast to each input's dtype,
    # then autograd through the fold
    torch.autograd.backward(
        [*fp, pb], [a.to(b.dtype) for a, b in zip(g, fp)] + [db.to(pb.dtype)])
    raw = [dx.float().numpy()] + [t.grad.numpy() for t in leaves]
    return dx, g, db, raw, fp, pb, dpf


def _autograd(x, dz, fp, pb, dpf, nh, softmax):
    leaves = [t.detach().clone().requires_grad_(True) for t in [x, *fp, pb]]
    y = bt.block_train_reference(leaves[0], FastParams(*leaves[1:9]),
                                 leaves[9], dpf, num_heads=nh,
                                 softmax=softmax)
    y.backward(dz)
    return [t.grad.float() for t in leaves]


def _jax_grads(cs, softmax, monkeypatch):
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    dpf = None if cs["dpf"] is None else jnp.asarray(cs["dpf"])
    dt = jnp.bfloat16
    wout = jnp.asarray(cs["dz"], dt).astype(jnp.float32)

    def loss(x, p, bias):
        y = jbt.fused_swin_block_train(
            x, p, bias.astype(dt), dpf, num_heads=cs["nh"],
            windows_per_image=cs["nw"], interpret=True)
        return jnp.sum(y.astype(jnp.float32) * wout)

    args = (jnp.asarray(cs["x"], dt), [jnp.asarray(a) for a in cs["p"]],
            jnp.asarray(cs["bias"]))
    g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(g)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(1e-6, float(np.abs(b).max()))


def _check(cs, softmax, monkeypatch):
    dx, g, db, raw, fp, pb, dpf = _staged(cs, softmax)
    want = _autograd(_bf(cs["x"]), _bf(cs["dz"]), fp, pb, dpf, cs["nh"],
                     softmax)
    for i, (a, b) in enumerate(zip([dx.float(), *g, db], want)):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_TOL, ("autograd", i)
    ref = _jax_grads(cs, softmax, monkeypatch)
    assert len(raw) == len(ref) == 14
    for i, (a, b) in enumerate(zip(raw, ref)):
        assert _rel(a, b) <= GRAD_TOL, ("jax", i)


CASES = [
    ("clamp", False, False, ""), ("clamp", True, True, ""),
    ("clamp", False, True, "over60"),
    ("stable", False, True, ""), ("stable", True, False, ""),
    ("stable", True, True, "ties"),
    ("stable_mm", False, False, ""), ("stable_mm", True, True, ""),
    ("stable_mm", False, False, "ties"),
]


@pytest.mark.parametrize(
    "softmax,per_window,with_dpf,scores", CASES,
    ids=[f"{s}-{'per_window' if w else 'shared'}{'-dpf' if d else ''}"
         f"{'-' + k if k else ''}" for s, w, d, k in CASES])
def test_staged_vjp_matches_autograd_and_jax(monkeypatch, softmax,
                                             per_window, with_dpf, scores):
    cs = _case(0, 12, 2, 4, 4, 2, per_window, with_dpf, scores)
    if scores == "ties":  # every row's max is shared by two or more keys
        bias = cs["bias"].reshape(-1, 16)
        assert ((bias == bias.max(axis=1, keepdims=True)).sum(1) > 1).all()
    _check(cs, softmax, monkeypatch)


def test_staged_vjp_at_swinir_std_width(monkeypatch):
    cs = _case(1, 180, 6, 8, 9, 1, False, True)
    _check(cs, "clamp", monkeypatch)


@pytest.mark.parametrize("softmax,with_dpf", [("clamp", False),
                                              ("stable", True),
                                              ("stable_mm", True)])
def test_staged_vjp_chains_through_the_pair(softmax, with_dpf):
    """Block b's staged VJP at block a's rolled output, its input
    cotangent unshifted into block a's output cotangent (in bf16, as the
    card's image-layout scratch holds it), then block a's: against
    autograd of ``pair_train_reference``."""
    rng = np.random.default_rng(3)
    c, nh, ws, size, shift, images = 12, 2, 4, (8, 8), 2, 2
    n, nw = ws * ws, 4
    t = images * nw
    pa = fast_params([torch.from_numpy(a) for a in _params(rng, c, 2 * c)],
                     c, nh)
    pb = fast_params([torch.from_numpy(a) for a in _params(rng, c, 2 * c)],
                     c, nh)
    ba = pack_bias_fast(torch.from_numpy(
        rng.normal(0, 0.5, (nh, n, n)).astype(np.float32)), nh, n)
    bb = pack_bias_fast(torch.from_numpy(
        rng.normal(0, 0.5, (nh * nw, n, n)).astype(np.float32)), nh, n)
    x = _bf(rng.normal(0, 0.5, (t, n, c)).astype(np.float32))
    dz = _bf(rng.normal(0, 1, (t, n, c)).astype(np.float32))
    dpf = None
    if with_dpf:
        f = rng.choice([0.0, 1 / 0.9], (images, 4)).astype(np.float32)
        dpf = torch.from_numpy(np.repeat(f, nw * n, axis=0))
    cols = (lambda i: None) if dpf is None else (lambda i: dpf[:, i:i + 2])
    kw = dict(num_heads=nh, softmax=softmax)

    y = bt.block_train_reference(x, pa, ba, cols(0), **kw)
    y2 = shift_relayout(y, size, ws, shift)
    dx_b, gb, dbb = bt.block_bwd_reference(y2, dz, pb, bb, cols(2), **kw)
    dy = unshift_relayout(dx_b, size, ws, shift)
    dx, ga, dba = bt.block_bwd_reference(x, dy, pa, ba, cols(0), **kw)

    leaves = [a.detach().clone().requires_grad_(True)
              for a in [x, *pa, ba, *pb, bb]]
    z = pt.pair_train_reference(
        leaves[0], FastParams(*leaves[1:9]), leaves[9],
        FastParams(*leaves[10:18]), leaves[18], dpf, x_size=size,
        window_size=ws, shift=shift, **kw)
    z.backward(dz)
    got = [dx.float(), *ga, dba, *gb, dbb]
    for i, (a, b) in enumerate(zip(got, leaves)):
        assert _rel(a.detach().numpy(), b.grad.float().numpy()) <= GRAD_TOL, i
