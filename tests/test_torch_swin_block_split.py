"""The f32 block's 3xTF32 design and the token-parallel fast block's
weight layouts, on the CPU (``rdst_tpu_torch.kernels.swin_block``).

The f32 kernel runs its four projections on the tensor cores as 3xTF32:
each operand is split as big = tf32_rna(x), small = tf32_rna(x - big), and
a product sums small*big' + big*small' + big*big'. These tests hold, in
plain PyTorch:

* the split: round to nearest with ties away from zero at 10 mantissa
  bits, and big + small equal to x within 2^-21 of |x|;
* the staged plain version of the kernel's phases at its split points
  (``swin_block_staged_f32``) against the JAX package's precise kernel in
  interpret mode and against ``swin_block_reference``, at 1e-4 max abs
  (the kernel's bar on the card);
* the f32 plan's layout: shapes, zero pads, big + small = the weights;
* the token-parallel fast forward's layouts (q/k/v by head, int8 included)
  against the folded weights they come from. That forward rounds where
  ``swin_block_fast_reference`` rounds, so no staged bf16 version is
  needed.

Inputs come from a numpy seed, as in ``tests/test_torch_swin_block.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu_torch.kernels import swin_block as sb
from rdst_tpu_torch.kernels.quant import qkv_quant

from test_torch_swin_block import N, NH, NW, _block_inputs

TOL = 1e-4  # KERNEL_TOL of chip_smoke.py: the f32 kernel vs its plain version
ULP = 2.0 ** -23


def _f32(values):
    return torch.tensor(values, dtype=torch.float64).float()


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),        # a tie: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),  # the same, negative
    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),     # a tie next to an odd step
    (1 + 2.0 ** -11 - ULP, 1.0),             # just below the tie
    (1 + 2.0 ** -11 + ULP, 1 + 2.0 ** -10),  # just above it
    (1.5, 1.5),                              # exact
    (2.0 - ULP, 2.0),                        # rounds up into the next binade
    (0.0, 0.0),
], ids=["tie", "tie_negative", "tie_odd", "below", "above", "exact",
        "binade", "zero"])
def test_tf32_round_is_nearest_ties_away(x, want):
    got = sb.tf32_round(_f32([x]))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_split_reproduces_f32():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, 4096) * 10.0 ** rng.uniform(-6, 6, 4096)
    x = torch.from_numpy(x.astype(np.float32))
    big, small = sb.tf32_split(x)
    assert torch.equal(sb.tf32_round(big), big)
    assert torch.equal(sb.tf32_round(small), small)
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # the big part alone is a TF32 product's operand: ~2^-11 relative
    assert (big.double() - x.double()).abs().max() > 2.0 ** -16 * \
        x.double().abs().max()


def test_mm3_is_close_to_a_float64_product():
    """The premise of the design: 3xTF32 keeps a product within a few
    f32 roundings, where one TF32 product is off by ~1e-3."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(0, 1, (256, 120)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 120 ** -0.5, (120, 360))
                         .astype(np.float32))
    exact = a.double() @ w.double()
    got = sb.mm3(a, *sb.tf32_split(w))
    one = (sb.tf32_round(a).double() @ sb.tf32_round(w).double())
    scale = exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 4e-7 * scale
    assert (one - exact).abs().max().item() >= 1e-4 * scale


@pytest.mark.parametrize("shifted", [False, True], ids=["shared", "shifted"])
@pytest.mark.parametrize("c", [60, 90, 120])
def test_staged_f32_matches_jax_and_plain(c, shifted):
    x, params, bias = _block_inputs(c, shifted, seed=5)
    want = np.asarray(jax_sb.fused_swin_block(
        jnp.asarray(x), *[jnp.asarray(p) for p in params], jnp.asarray(bias),
        num_heads=NH, windows_per_image=NW, interpret=True))
    args = [torch.from_numpy(a) for a in (x, *params, bias)]
    kw = dict(num_heads=NH, windows_per_image=NW)
    staged = sb.swin_block_staged_f32(*args, **kw)
    plain = sb.swin_block_reference(*args, **kw)
    assert staged.shape == x.shape and staged.dtype == torch.float32
    assert np.abs(staged.numpy() - want).max() <= TOL
    assert (staged - plain).abs().max().item() <= TOL


@pytest.mark.parametrize("c,hid", [(60, 120), (90, 180), (120, 240),
                                   (168, 336)])
def test_f32_layout(c, hid):
    x, params, bias = _block_inputs(c, False, seed=6)
    params = [torch.from_numpy(p) for p in params]
    params[8] = torch.randn(c, hid)
    params[9] = torch.randn(hid)
    params[10] = torch.randn(hid, c)
    lay = sb.f32_kernel_layout(params)
    kp, n3, hp = (-(-v // 8) * 8 for v in (c, 3 * c, hid))
    shapes = [(kp, n3), (kp, n3), (n3,), (kp, kp), (kp, kp), (c,), (c,),
              (c,), (c,), (c,), (kp, hp), (kp, hp), (hid,), (hp, kp),
              (hp, kp), (c,)]
    assert [tuple(t.shape) for t in lay] == shapes
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in lay)
    for (bi, si), w in zip(((0, 1), (3, 4), (10, 11), (13, 14)),
                           (params[0], params[2], params[8], params[10])):
        big, small = lay[bi], lay[si]
        r, k = w.shape
        assert torch.equal(sb.tf32_round(big), big)
        err = (big[:r, :k].double() + small[:r, :k].double() - w.double())
        assert (err.abs() <= 2.0 ** -21 * w.double().abs()).all()
        assert not big[r:].any() and not big[:, k:].any()
        assert not small[r:].any() and not small[:, k:].any()
    assert torch.equal(lay[2][:3 * c], params[1]) and not lay[2][3 * c:].any()
    plan = sb.plan_f32_block(params, torch.from_numpy(bias), num_heads=NH)
    assert plan.layout == ()  # split on a CUDA device only
    none = list(params)
    none[1] = None
    assert torch.equal(sb.plan_f32_block(none, torch.from_numpy(bias),
                                         num_heads=NH).params[1],
                       torch.zeros(3 * c))


def _folded(c, seed=7):
    x, params, bias = _block_inputs(c, False, seed=seed)
    return sb.fast_params([torch.from_numpy(p) for p in params], c, NH)


def _by_head(c, nh, hdg):
    """Columns (part, head, channel) of the by-head layout, in the folded
    weight's (part, head, channel) order."""
    hd = c // nh
    return [part * nh * hdg + h * hdg + d for part in range(3)
            for h in range(nh) for d in range(hd)]


@pytest.mark.parametrize("c", [60, 90, 120, 180])
def test_token_layout_orders_qkv_by_head(c):
    p = _folded(c)
    hidden = p.w1.shape[1]
    kp, hp, hdg, n3, kq = sb.token_dims(c, NH, hidden)
    wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2 = sb.token_layout(p, NH)
    assert (tuple(wqkv.shape), tuple(bqkv.shape)) == ((kp, n3), (n3,))
    assert [tuple(t.shape) for t in (wproj, w1, w2)] == \
        [(kp, kp), (kp, hp), (hp, kp)]
    cols = _by_head(c, NH, hdg)
    assert torch.equal(wqkv[:c, cols], p.wqkv)
    assert torch.equal(bqkv[cols], p.bqkv)
    pad = torch.ones(n3, dtype=torch.bool)
    pad[cols] = False
    assert not wqkv[:, pad].float().any() and not bqkv[pad].any()
    assert not wqkv[c:].float().any()
    for got, want in ((wproj, p.wproj), (w1, p.w1), (w2, p.w2)):
        r, k = want.shape
        assert torch.equal(got[:r, :k], want)
        assert not got[r:].float().any() and not got[:, k:].float().any()
    assert bproj is p.bproj and bf1 is p.bf1 and bf2 is p.bf2
    # the int8 operands in the same order, (out, in)
    q = qkv_quant(p.wqkv)
    wq, ws = sb.qkv_token_layout(q, c, NH)
    assert (tuple(wq.shape), wq.dtype) == ((n3, kq), torch.int8)
    assert torch.equal(wq[cols, :c], q.wq.t())
    assert torch.equal(ws[cols], q.ws)
    assert not wq[pad].any() and not wq[:, c:].any() and not ws[pad].any()
    assert sb.qkv_token_layout(None, c, NH) == ()


def test_fast_route_by_width():
    """The plan picks the design from C alone; the pair keeps the window
    body whatever the width."""
    for c in (60, 90, 120, 180, 192):
        assert sb.fast_route(c) == ("window" if c <= sb.WINDOW_MAX_C
                                    else "tokens")
    x, params, bias = _block_inputs(60, False, seed=8)
    params = [torch.from_numpy(a) for a in params]
    bias = torch.from_numpy(bias).to(torch.bfloat16)
    assert sb.plan_fast_block(params, bias, num_heads=NH).route == \
        sb.fast_route(60)
    for route in ("window", "tokens"):
        plan = sb.plan_fast_block(params, bias, num_heads=NH, route=route)
        assert (plan.route, plan.layout, plan.qkv_layout) == (route, (), ())
    with pytest.raises(ValueError, match="route"):
        sb.plan_fast_block(params, bias, num_heads=NH, route="pair")


@pytest.mark.parametrize("route", ["window", "tokens"])
def test_cpu_fast_block_takes_plain_version_on_either_route(route):
    x, params, bias = _block_inputs(60, True, seed=9)
    params = [torch.from_numpy(a) for a in params]
    bias = torch.from_numpy(bias).to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    plan = sb.plan_fast_block(params, bias, num_heads=NH, route=route)
    before = sb.run_fast_block.launches
    got = sb.run_fast_block(xb, plan, num_heads=NH, windows_per_image=NW,
                            softmax="clamp")
    want = sb.swin_block_fast_reference(xb, plan.params, plan.bias,
                                        num_heads=NH, softmax="clamp")
    assert torch.equal(got, want)
    assert sb.run_fast_block.launches == before
