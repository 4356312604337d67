"""The DSTL-pair kernel's port: ``rdst_tpu_torch.kernels.swin_pair``
against ``rdst_tpu.kernels.swin_block.fused_swin_pair`` (bf16, interpret
mode, as ``tests/test_kernels.py`` runs it).

* the relayout (window_reverse -> roll -> window_partition) against
  ``_shift_relayout`` / ``_unshift_relayout``: exact (a permutation);
* the plain version (the wrapper's CPU path) against the JAX kernel,
  output in the shifted window layout: <= 0.01 relative max error, the
  same bar and reasons as ``test_torch_swin_block_fast.py`` (measured:
  <= 0.005).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu_torch.kernels import swin_pair as sp
from test_torch_swin_block_fast import H, NW, W, WS, block_inputs, rel_err

TOL = 0.01


@pytest.mark.parametrize("shift", [4, 0])
def test_shift_relayout_matches_jax(shift):
    y = np.random.default_rng(0).normal(size=(2 * NW, WS * WS, 5)).astype(
        np.float32)
    flat = jnp.asarray(y).reshape(-1, 5)
    geom = (2, H // WS, W // WS, WS, shift)
    want = np.asarray(jax_sb._shift_relayout(flat, *geom)).reshape(y.shape)
    got = sp.shift_relayout(torch.from_numpy(y), (H, W), WS, shift).numpy()
    assert np.array_equal(got, want)
    back = np.asarray(jax_sb._unshift_relayout(jnp.asarray(want).reshape(
        -1, 5), *geom)).reshape(y.shape)
    assert np.array_equal(back, y)
    assert np.array_equal(sp.unshift_relayout(torch.from_numpy(got), (H, W),
                                              WS, shift).numpy(), y)


@pytest.mark.parametrize("softmax", ["stable", "clamp"])
@pytest.mark.parametrize("c,nh", [(12, 3), (60, 6)], ids=["c12", "c60"])
def test_reference_matches_jax_pair(monkeypatch, c, nh, softmax):
    x, pa, ba = block_inputs(c, nh, False, seed=3)
    _, pb, bb = block_inputs(c, nh, True, seed=4)
    if softmax == "stable":
        monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    # the bf16 pair: no int8 group left in the environment by a JAX model
    # built earlier in this process (a config's pallas_quant)
    monkeypatch.delenv("RDST_TPU_PALLAS_QUANT", raising=False)
    clear_kernel_caches()
    bf = jnp.bfloat16
    want = np.asarray(jax_sb.fused_swin_pair(
        jnp.asarray(x).astype(bf), [jnp.asarray(p) for p in pa],
        jnp.asarray(ba).astype(bf), [jnp.asarray(p) for p in pb],
        jnp.asarray(bb).astype(bf), num_heads=nh, x_size=(H, W),
        window_size=WS, shift=WS // 2, interpret=True).astype(jnp.float32))
    clear_kernel_caches()
    t = torch.from_numpy
    before = sp.run_swin_pair.launches
    got = sp.fused_swin_pair(
        t(x).bfloat16(), [t(p) for p in pa], t(ba).bfloat16(),
        [t(p) for p in pb], t(bb).bfloat16(), num_heads=nh, x_size=(H, W),
        window_size=WS, shift=WS // 2, softmax=softmax)
    assert sp.run_swin_pair.launches == before  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert rel_err(got.float().numpy(), want) <= TOL


def test_pair_equals_two_blocks_with_relayout():
    """The pair is block a, the bf16 relayout, block b: the same numbers
    as two single fast blocks around ``shift_relayout``."""
    from rdst_tpu_torch.kernels import swin_block as sb

    x, pa, ba = block_inputs(12, 3, False, seed=5)
    _, pb, bb = block_inputs(12, 3, True, seed=6)
    t = torch.from_numpy
    xb = t(x).bfloat16()
    got = sp.fused_swin_pair(xb, [t(p) for p in pa], t(ba).bfloat16(),
                             [t(p) for p in pb], t(bb).bfloat16(),
                             num_heads=3, x_size=(H, W), window_size=WS,
                             shift=4, softmax="clamp")
    y = sb.fused_swin_block(xb, *[t(p) for p in pa], t(ba).bfloat16(),
                            num_heads=3, windows_per_image=NW,
                            softmax="clamp")
    y = sp.shift_relayout(y, (H, W), WS, 4)
    want = sb.fused_swin_block(y, *[t(p) for p in pb], t(bb).bfloat16(),
                               num_heads=3, windows_per_image=NW,
                               softmax="clamp")
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw,ws,shift", [((14, 24), 7, 3), ((16, 24), 8, 8)],
                         ids=["window7", "shift_eq_window"])
def test_pair_refuses_geometry_without_launch(hw, ws, shift):
    n, c, nh = ws * ws, 12, 3
    nw = (hw[0] // ws) * (hw[1] // ws)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    def params():
        return [r(c, 3 * c), r(3 * c), r(c, c), r(c), r(c), r(c), r(c),
                r(c), r(c, 2 * c), r(2 * c), r(2 * c, c), r(c)]

    before = sp.run_swin_pair.launches
    with pytest.raises(ValueError, match="does not take"):
        sp.fused_swin_pair(r(nw, n, c).bfloat16(), params(),
                           r(nh, n, n).bfloat16(), params(),
                           r(nh * nw, n, n).bfloat16(), num_heads=nh,
                           x_size=hw, window_size=ws, shift=shift)
    assert sp.run_swin_pair.launches == before
