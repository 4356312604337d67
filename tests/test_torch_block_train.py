"""The single-block train kernel's plain version (``kernels.block_train``)
and its ``torch.autograd`` gradient against the JAX kernel on the CPU.

* At C = 12, 2 heads, window 4 (N = 16), 2 images of 8x8 (4 windows
  each): shared and per-window bias, with and without stochastic-depth
  factor columns (the same columns on both sides), under 'clamp' and
  'stable' (each of the four pairs once): the output against
  ``rdst_tpu.kernels.block_train.fused_swin_block_train(interpret=True)``
  and every gradient (tokens, the 12-param bundle, the bias) against
  ``jax.grad`` of it.
* At SwinIR-std's width C = 180, 6 heads, window 8, on one 24x24 image
  (9 windows: the JAX kernel's grid of 3 chunks of 3 windows): the same.
* Bars: output 1e-2, gradients 2e-2, relative to the reference's max.
* The admission table (which layers the JAX package trains on the pair
  kernel and which on this one), reproduced by the port's own copies of
  the rules, against the JAX functions and the values they give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import block_train as jbt
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import pair_train as jpt
from rdst_tpu.kernels import swin_block as jsb
from rdst_tpu_torch.kernels import block_train as bt
from rdst_tpu_torch.kernels import swin_block as sb
from rdst_tpu_torch.kernels import token_wgmma as tw

OUT_TOL, GRAD_TOL = 1e-2, 2e-2


def _params(rng, c, hid):
    def arr(*s, scale=0.5):
        return rng.normal(0, scale, s).astype(np.float32)

    return [arr(c, 3 * c, scale=c ** -0.5), arr(3 * c, scale=0.1),
            arr(c, c, scale=c ** -0.5), arr(c, scale=0.1),
            1 + 0.1 * arr(c), 0.1 * arr(c), 1 + 0.1 * arr(c), 0.1 * arr(c),
            arr(c, hid, scale=c ** -0.5), arr(hid, scale=0.1),
            arr(hid, c, scale=hid ** -0.5), arr(c, scale=0.1)]


def _case(seed, c, nh, ws, nw, images, per_window, with_dpf):
    rng = np.random.default_rng(seed)
    n = ws * ws
    bias = rng.normal(0, 0.5, ((nh * nw if per_window else nh), n, n)
                      ).astype(np.float32)
    x = np.asarray(jnp.asarray(rng.normal(0, 0.5, (images * nw, n, c)),
                               jnp.bfloat16).astype(jnp.float32))
    dpf = None
    if with_dpf:
        f = np.array([[0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9],
                      [1 / 0.9, 0.0]], np.float32)[:images]
        dpf = np.repeat(f, nw * n, axis=0)
    wout = rng.normal(0, 1, (images * nw, n, c)).astype(np.float32)
    return dict(x=x, p=_params(rng, c, 2 * c), bias=bias, dpf=dpf,
                wout=wout, nh=nh, nw=nw)


def _torch_side(cs, softmax):
    x = torch.from_numpy(cs["x"].copy()).to(torch.bfloat16).requires_grad_(
        True)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in cs["p"] + [cs["bias"]]]
    dpf = None if cs["dpf"] is None else torch.from_numpy(cs["dpf"])
    before = bt.launch_forward.launches, bt.launch_backward.launches
    y = bt.fused_swin_block_train(
        x, leaves[:12], leaves[12].to(torch.bfloat16), dpf,
        num_heads=cs["nh"], windows_per_image=cs["nw"], softmax=softmax)
    (y.float() * torch.from_numpy(cs["wout"])).sum().backward()
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (bt.launch_forward.launches, bt.launch_backward.launches) == before
    grads = [x.grad.float().numpy()] + [t.grad.numpy() for t in leaves]
    return y.float().detach().numpy(), grads


def _jax_side(cs, softmax, monkeypatch):
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    dpf = None if cs["dpf"] is None else jnp.asarray(cs["dpf"])
    wout = jnp.asarray(cs["wout"])
    dt = jnp.bfloat16

    def fn(x, p, bias):
        return jbt.fused_swin_block_train(
            x, p, bias.astype(dt), dpf, num_heads=cs["nh"],
            windows_per_image=cs["nw"], interpret=True)

    def loss(*args):
        return jnp.sum(fn(*args).astype(jnp.float32) * wout)

    args = (jnp.asarray(cs["x"], dt), [jnp.asarray(a) for a in cs["p"]],
            jnp.asarray(cs["bias"]))
    y = np.asarray(fn(*args), np.float32)
    g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    grads = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(g)]
    return y, grads


def _compare(got, want):
    y, gs = got
    y_ref, gs_ref = want
    assert float(np.abs(y - y_ref).max()) <= OUT_TOL * np.abs(y_ref).max()
    assert len(gs) == len(gs_ref) == 14
    for i, (a, b) in enumerate(zip(gs, gs_ref)):
        denom = max(1e-6, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) / denom <= GRAD_TOL, i


@pytest.mark.parametrize("softmax,per_window,with_dpf", [
    ("clamp", False, False), ("clamp", True, True),
    ("stable", False, True), ("stable", True, False)],
    ids=["clamp-shared", "clamp-per_window_dpf", "stable-shared_dpf",
         "stable-per_window"])
def test_plain_matches_jax_kernel(monkeypatch, softmax, per_window,
                                  with_dpf):
    cs = _case(0, 12, 2, 4, 4, 2, per_window, with_dpf)
    _compare(_torch_side(cs, softmax), _jax_side(cs, softmax, monkeypatch))


def test_plain_matches_jax_kernel_at_swinir_std_width(monkeypatch):
    """C = 180 on one 24x24 image: the JAX kernel steps over 3 chunks of 3
    windows (``_chunk_geometry``), the port has no chunks; the sums are
    the same."""
    assert jbt._chunk_geometry(9, 9, 64, 180, 6, 360, 2, 1, 1) == (3, 1, 1)
    cs = _case(1, 180, 6, 8, 9, 1, False, True)
    _compare(_torch_side(cs, "clamp"), _jax_side(cs, "clamp", monkeypatch))


# (C, fused_pair_train_fits, fused_block_train_fits, (t, tile, nblk) of a
# per-window bias) at the training geometry: 9 windows of 64 tokens, 6
# heads, hidden 2C
ADMISSION = [
    (60, True, True, (9, 9, 1)), (90, True, True, (9, 9, 1)),
    (96, True, True, (9, 9, 1)), (120, True, True, (9, 9, 1)),
    (144, False, True, (3, 3, 3)), (180, False, True, (3, 3, 3)),
    (192, False, True, (3, 3, 3)),
]


@pytest.mark.parametrize("softmax", ["", "clamp"])
@pytest.mark.parametrize("c,pair,block,geom", ADMISSION,
                         ids=[f"c{row[0]}" for row in ADMISSION])
def test_admission_table(monkeypatch, softmax, c, pair, block, geom):
    """The port's copies of ``fused_pair_train_fits``,
    ``fused_block_train_fits``, ``_chunk_geometry`` and ``_vmem_estimate``
    give what the JAX functions give (their softmax variant read from the
    environment at trace time), and the table above."""
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    args = (9, 64, c, 6, 2 * c)
    assert bt.fused_pair_train_fits(*args, 2, softmax) is \
        jpt.fused_pair_train_fits(*args, 2) is pair
    assert bt.fused_block_train_fits(*args, 2, softmax) is \
        jbt.fused_block_train_fits(*args, 2) is block
    assert bt.chunk_geometry(288, 9, 64, c, 6, 2 * c, 2, 9, 2, softmax) == \
        jbt._chunk_geometry(288, 9, 64, c, 6, 2 * c, 2, 9, 2) == geom
    for t in (3, 9, 18):
        for fast in (False, True):
            assert bt.vmem_estimate(t, 64, c, 6, 2 * c, 9, 2, fast,
                                    softmax) == \
                jsb._vmem_estimate(t, 64, c, 6, 2 * c, 9, 2, fast)


def test_wrapper_refuses_geometry():
    """What the CUDA kernels do not take raises on the CPU as on the card:
    C past 192, a bias of the wrong period, factor columns of the wrong
    shape."""
    rng = np.random.default_rng(2)

    def fp(c):
        return sb.fast_params([torch.from_numpy(a)
                               for a in _params(rng, c, 2 * c)], c, 6)

    bias = torch.zeros(1, 64, 6 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pallas_train='off'"):
        bt.run_block_train(torch.zeros(9, 64, 198, dtype=torch.bfloat16),
                           fp(198), bias, num_heads=6, windows_per_image=9)
    x = torch.zeros(9, 64, 180, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not fit"):
        bt.run_block_train(x, fp(180), bias.expand(3, -1, -1),
                           num_heads=6, windows_per_image=9)
    with pytest.raises(ValueError, match="dp_cols"):
        bt.run_block_train(x, fp(180), bias, torch.ones(9 * 64, 4),
                           num_heads=6, windows_per_image=9)


# ---------------------------------------------------------------------------
# The forward on the token-parallel forward (csrc/block_train.cu ->
# csrc/token_fwd.cuh): its phases over the kernels' buffers with the two
# training differences, the exact division and the factor columns
# ---------------------------------------------------------------------------

STAGED_TOL = 0.02  # the port's bf16 bar (bf16 roundings in another order)


def _staged_forward(cs, softmax):
    """(token_block_staged, block_train_reference) on one case."""
    c, nh = cs["x"].shape[-1], cs["nh"]
    x = torch.from_numpy(cs["x"].copy()).to(torch.bfloat16)
    p = sb.fast_params([torch.from_numpy(a) for a in cs["p"]], c, nh)
    bias = sb.pack_bias_fast(torch.from_numpy(cs["bias"]).to(torch.bfloat16),
                             nh, cs["x"].shape[1])
    dpf = None if cs["dpf"] is None else torch.from_numpy(cs["dpf"])
    got = tw.token_block_staged(x, bt.forward_layout(p, nh), (), bias, dpf,
                                num_heads=nh, softmax=softmax)
    plain = bt.block_train_reference(x, p, bias, dpf, num_heads=nh,
                                     softmax=softmax)
    return got.float().numpy(), plain.float().numpy()


def _jax_forward(cs, softmax, monkeypatch):
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    dt = jnp.bfloat16
    dpf = None if cs["dpf"] is None else jnp.asarray(cs["dpf"])
    y = jbt.fused_swin_block_train(
        jnp.asarray(cs["x"], dt), [jnp.asarray(a) for a in cs["p"]],
        jnp.asarray(cs["bias"]).astype(dt), dpf, num_heads=cs["nh"],
        windows_per_image=cs["nw"], interpret=True)
    clear_kernel_caches()
    return np.asarray(y, np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("softmax", ["clamp", "stable"])
@pytest.mark.parametrize("with_dpf", [False, True], ids=["no_dpf", "dpf"])
@pytest.mark.parametrize("c,nh,ws,per_window", [(12, 2, 4, True),
                                                (60, 6, 8, False)],
                         ids=["c12_per_window", "c60_shared"])
def test_staged_token_forward_with_training_differences(
        monkeypatch, c, nh, ws, per_window, with_dpf, softmax):
    """``token_wgmma.token_block_staged`` with the factor columns, on the
    weights ``forward_layout`` lays out for the kernels, against the plain
    version and the JAX kernel's forward in interpret mode."""
    cs = _case(4 + c, c, nh, ws, 4, 2, per_window, with_dpf)
    got, plain = _staged_forward(cs, softmax)
    assert _rel(got, plain) <= STAGED_TOL
    assert _rel(got, _jax_forward(cs, softmax, monkeypatch)) <= STAGED_TOL


def test_staged_token_forward_at_swinir_std_width(monkeypatch):
    cs = _case(5, 180, 6, 8, 9, 1, False, True)
    got, plain = _staged_forward(cs, "clamp")
    assert _rel(got, plain) <= STAGED_TOL
    assert _rel(got, _jax_forward(cs, "clamp", monkeypatch)) <= STAGED_TOL


def test_factor_columns_scale_each_branch():
    """A zero factor drops its branch: with the attention column 0 the
    projection adds nothing to x1, with both 0 the block is the identity
    (up to the output's bf16 rounding)."""
    cs = _case(6, 12, 2, 4, 4, 1, False, False)
    n = cs["x"].shape[0] * cs["x"].shape[1]
    cs["dpf"] = np.zeros((n, 2), np.float32)
    got, plain = _staged_forward(cs, "clamp")
    assert np.array_equal(got, cs["x"]) and np.array_equal(plain, cs["x"])


def test_training_geometry_schedule():
    """18,432 tokens (32 images of 24x24 at C = 180): every GEMM of the
    forward takes the tile rows of ``token_tile_rows`` (the source's
    ``tokwg::tile_rows``), whose persistent blocks cover every row once."""
    t = 288 * 64
    bm = sb.token_tile_rows(t)
    scheds = sb.token_gemm_scheds(t, 180, 6, 360)
    assert {s.bm for s in scheds.values()} == {bm}
    blocks = sb.token_schedule(t, bm)
    covered = np.zeros(t, np.int64)
    for b in blocks:
        for lo, hi in b:
            covered[lo:hi] += 1
    assert (covered == 1).all()
    assert sum(len(b) for b in blocks) == scheds["qkv"].tiles == -(-t // bm)
    assert all(s.nslots >= 2 and s.smem <= sb.H100_SMEM_OPTIN
               for s in scheds.values())


@pytest.mark.parametrize("c", [144, 180, 192])
def test_forward_admits_the_block_train_widths(c):
    """SwinIR-std's C = 180 and RDST-W96's block-train layers (C = 144 and
    192) at 64-token windows."""
    assert bt.block_train_kernel_supports(64, c, 6, 2 * c)
    layout = bt.forward_layout(sb.FastParams(
        *[torch.zeros(*s) for s in ((c, 3 * c), (3 * c,), (c, c), (c,),
                                    (c, 2 * c), (2 * c,), (2 * c, c),
                                    (c,))]), 6)
    kp, hp, _, n3, _ = sb.token_dims(c, 6, 2 * c)
    assert [tuple(a.shape) for a in layout] == [
        (n3, kp), (n3,), (kp, kp), (c,), (hp, kp), (2 * c,), (kp, hp), (c,)]
