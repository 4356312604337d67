"""The token-parallel forward's wgmma GEMMs (``csrc/token_wgmma.cuh``) on
the CPU: their plan (``rdst_tpu_torch.kernels.swin_block``) and their
plain versions (``rdst_tpu_torch.kernels.token_wgmma``).

The kernels themselves run only on the card (``chip_smoke.py``, the
token GEMM phase and phases 7, 14 and 20). Here:

* the K-major weight layout the GEMMs read transposes back to
  ``token_layout``'s matrices, and the int8 qkv operands are the
  ``qkv_token_layout`` rows (n3, kq) [n][k] as they were;
* the plan's shared-memory budget and admission: every geometry the
  shipped configs run is admitted, and the admitted set is the one the
  mma.sync design admitted (its rule kept here as the yardstick);
* the persistent schedule: each token row in exactly one tile of one
  block, at both tile heights, from 64 to 81,920 tokens;
* the four GEMMs' plain versions chained over the kernels' buffer layouts
  (``token_block_staged``) against the block's plain version (bitwise:
  the same roundings at the same places) and the JAX fast kernel in
  interpret mode (bar 0.01, as ``tests/test_torch_swin_block_fast.py``),
  int8 and bf16 qkv;
* each wrapper on CPU tensors is its plain version and counts no launch.

Inputs come from a numpy seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu_torch.kernels import rdstb_block as rb
from rdst_tpu_torch.kernels import swin_block as sb
from rdst_tpu_torch.kernels import swin_pair as sp
from rdst_tpu_torch.kernels import token_wgmma as tw

from test_torch_swin_block_fast import NW, block_inputs, rel_err

TOL = 0.01  # the plain versions vs the JAX kernel in interpret mode
NH = 6
# (n, C, hidden, growth) of every block the shipped configs run on the
# token-parallel forward or may: RDST-W96's DSTLs (growth 48), SwinIR-std,
# SwinIR-light, RDST-E1's widths with int8 qkv
SHIPPED = ([(64, c, 2 * c, 48) for c in (96, 144, 192)]
           + [(64, 180, 360, 0), (64, 60, 120, 0)]
           + [(64, c, 2 * c, 30) for c in (60, 90, 120)])


def _plan(c, nh, shifted, quant, seed=0):
    x, params, bias = block_inputs(c, nh, shifted, seed=seed)
    plan = sb.plan_fast_block([torch.from_numpy(p) for p in params],
                              torch.from_numpy(bias).to(torch.bfloat16),
                              num_heads=nh, quant=quant, route="tokens")
    return x, params, bias, plan


@pytest.mark.parametrize("c", [12, 60, 96, 144, 180, 192])
def test_wgmma_layout_unpacks_to_token_layout(c):
    nh = 3 if c == 12 else NH
    _, _, _, plan = _plan(c, nh, False, frozenset({"qkv"}))
    tl = sb.token_layout(plan.params, nh)
    wl = sb.token_wgmma_layout(tl)
    kp, hp, _, n3, kq = sb.token_dims(c, nh, plan.params.w1.shape[1])
    shapes = [(n3, kp), (kp, kp), (hp, kp), (kp, hp)]
    for i, shape in zip((0, 2, 4, 6), shapes):
        assert tuple(wl[i].shape) == shape and wl[i].is_contiguous()
        assert wl[i].dtype == torch.bfloat16
        assert torch.equal(wl[i].t(), tl[i])  # [n][k] back to [k][n]
    for i in (1, 3, 5, 7):  # the biases as they are
        assert wl[i] is tl[i]
    # the int8 qkv rows the kernel reads K-major are qkv_token_layout's
    wq, ws = sb.qkv_token_layout(plan.qkv, c, nh)
    assert (tuple(wq.shape), wq.dtype) == ((n3, kq), torch.int8)
    assert wq.is_contiguous() and kq % 32 == 0 and 2 * kp % 16 == 0


def _old_token_smem(n, c, nh, hidden, growth):
    """The mma.sync design's budget (PR 9-11), the yardstick of what the
    token-parallel forward admitted before the wgmma GEMMs."""
    def tile(bn, tb):
        b = 32 * (bn + 8) if tb else bn * 40
        return max(3 * (64 * 40 + b) * 2, 64 * (bn + 4) * 4)

    kp = -(-(c + 1) // 16) * 16
    span = next(w for w in (64, 128, 192, 256) if kp <= w or w == 256)
    hds = -(-(c // nh) // 16) * 16
    sizes = [tile(span, True), tile(128, True),
             max(3 * (64 * 80 + 128 * 80), 64 * 132 * 4),
             2 * 3 * n * (hds + 8)]
    if growth:
        sizes.append(tile(next(w for w in (64, 128, 192, 256)
                               if growth <= w), False))
    return max(sizes)


def _old_supports(n, c, nh, hidden, growth):
    if growth > 256:
        return False
    if growth:
        next(w for w in (64, 128, 192, 256) if growth <= w)
    return sb.fast_kernel_supports(
        n, c, nh, hidden, _old_token_smem(n, c, nh, hidden, growth),
        max_c=sb.FAST_MAX_C)


def test_shipped_geometries_admitted():
    for n, c, hidden, growth in SHIPPED:
        assert sb.token_kernel_supports(n, c, NH, hidden, growth)
        assert 0 < sb.token_smem_bytes(n, c, NH, hidden, growth) <= \
            sb.H100_SMEM_OPTIN
        for tokens in (1280, 81920):
            for int8 in (False, True):
                scheds = sb.token_gemm_scheds(tokens, c, NH, hidden, growth,
                                              int8)
                assert set(scheds) == ({"qkv", "proj", "mlp", "adapter"}
                                       if growth else {"qkv", "proj", "mlp"})
                for s in scheds.values():
                    assert s.nslots >= 2 and s.smem <= sb.H100_SMEM_OPTIN
                    assert s.bm == sb.token_tile_rows(tokens)
    # the hidden rows of 128-row tiles at hidden 512 leave no second slot
    wide = sb.token_gemm_scheds(81920, 192, NH, 512)["mlp"]
    assert (wide.bm, wide.h_bytes) == (64, 8 * 64 * 128)
    assert wide.nslots >= 2 and wide.smem <= sb.H100_SMEM_OPTIN


@pytest.mark.parametrize("n", [16, 32, 64, 40, 80])
@pytest.mark.parametrize("nh", [1, 3, 6])
def test_admission_is_the_old_set(n, nh):
    """Every (C, hidden, growth) on a grid around the limits: admitted now
    exactly where the mma.sync design admitted it (C <= 192, head dim <=
    32, hidden <= 512, growth <= 256, N a multiple of 16 up to 64)."""
    checked = 0
    for c in list(range(nh, 200, 7 * nh)) + [180, 192, 193, 198]:
        if c % nh:
            continue
        for hidden in (1, c, 2 * c, 512, 513):
            for growth in (0, 1, 48, 256, 257):
                want = _old_supports(n, c, nh, hidden, growth)
                assert sb.token_kernel_supports(n, c, nh, hidden,
                                                growth) == want, \
                    (n, c, nh, hidden, growth)
                checked += 1
    assert checked > 50


def test_refusals_kept():
    assert not sb.token_kernel_supports(64, 198, 6, 396)   # C > 192
    assert not sb.token_kernel_supports(64, 132, 3, 264)   # head dim 44
    assert not sb.token_kernel_supports(64, 96, 6, 520)    # hidden > 512
    assert not sb.token_kernel_supports(64, 96, 6, 192, 264)  # growth
    assert not sb.token_kernel_supports(36, 96, 6, 192)    # N % 16
    assert not sb.token_kernel_supports(64, 100, 6, 200)   # C % heads


@pytest.mark.parametrize("tokens", [64, 65, 960, 1280, 1281, 10240, 16895,
                                    16896, 16960, 40960, 81920])
def test_schedule_covers_every_row_once(tokens):
    bm = sb.token_tile_rows(tokens)
    assert bm == (128 if -(-tokens // 128) >= sb.H100_SMS else 64)
    blocks = sb.token_schedule(tokens, bm)
    assert 0 < len(blocks) <= sb.H100_SMS
    counts = [len(b) for b in blocks]
    assert max(counts) - min(counts) <= 1  # a persistent grid's waves
    covered = np.zeros(tokens, dtype=np.int64)
    for b in blocks:
        for lo, hi in b:
            assert hi - lo <= bm and lo % bm == 0
            covered[lo:hi] += 1
    assert (covered == 1).all()
    for s in sb.token_gemm_scheds(tokens, 192, NH, 384, 48, True).values():
        assert s.tiles == sum(counts)


def test_sched_mirrors_the_source_budget():
    """``tokwg::sched`` / ``smem_bytes`` at W96's widest MLP: one 48 KB A
    buffer, the 96 KB hidden rows (6 slices of 128 rows x 64 columns),
    bf1 and bf2 as f32 constants, three 24 KB slots, the alignment pad and
    the barriers."""
    s = sb.token_gemm_scheds(81920, 192, NH, 384, 48)["mlp"]
    assert (s.tiles, s.bm, s.nks, s.ksteps) == (640, 128, 3, 12)
    assert (s.na, s.a_bytes, s.h_bytes, s.c_bytes, s.slot_bytes,
            s.nslots) == (1, 49152, 6 * 16384, 4 * (384 + 192), 24576, 3)
    assert s.smem == (1024 + 49152 + 6 * 16384 + 4 * 576 + 3 * 24576 + 32
                      + 16 * 3)
    q = sb.token_gemm_scheds(1280, 192, NH, 384, 0, int8=True)["qkv"]
    assert (q.bm, q.tiles, q.nks, q.ksteps) == (64, 20, 2, 6)
    assert (q.h_bytes, q.c_bytes) == (64 * 128, 2 * 576 * 4)


@pytest.mark.parametrize("softmax", ["clamp", "stable_bc"])
@pytest.mark.parametrize("shifted", [False, True], ids=["shared", "shifted"])
@pytest.mark.parametrize("quant", [frozenset(), frozenset({"qkv"})],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("c,nh", [(12, 3), (60, 6)], ids=["c12", "c60"])
def test_staged_gemms_match_plain_and_jax(monkeypatch, c, nh, quant,
                                          shifted, softmax):
    x, params, bias, plan = _plan(c, nh, shifted, quant, seed=c)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tw.token_block_staged(
        xt, sb.token_wgmma_layout(sb.token_layout(plan.params, nh)),
        sb.qkv_token_layout(plan.qkv, c, nh), plan.bias, num_heads=nh,
        softmax=softmax)
    plain = sb.swin_block_fast_reference(xt, plan.params, plan.bias,
                                         num_heads=nh, softmax=softmax,
                                         qkv=plan.qkv)
    assert torch.equal(got, plain)
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    bf = jnp.bfloat16
    jp = [jnp.asarray(p) if i in (4, 5, 6, 7) else jnp.asarray(p, bf)
          for i, p in enumerate(params)]
    want = np.asarray(jax_sb.fused_swin_block(
        jnp.asarray(x, bf), *jp, jnp.asarray(bias, bf), num_heads=nh,
        windows_per_image=NW, interpret=True, quant=quant
    ).astype(jnp.float32))
    clear_kernel_caches()
    assert rel_err(got.float().numpy(), want) <= TOL


def test_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(5)
    c, hidden, growth, t = 60, 120, 30, 200
    kp, hp, _, n3, kq = sb.token_dims(c, NH, hidden)

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape)
                                .astype(np.float32))

    bf = torch.bfloat16
    xq = torch.from_numpy(rng.integers(-127, 128, (t, kq)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n3, kq)).astype(np.int8))
    xn, wqkv = f(t, kp).to(bf), f(n3, kp, scale=0.1).to(bf)
    ws, bqkv = f(n3).abs() * 1e-4, f(n3, scale=0.1)
    wproj, x, bproj = f(kp, kp, scale=0.1).to(bf), f(t, c).to(bf), \
        f(c).to(bf)
    w1, w2 = f(hp, kp, scale=0.1).to(bf), f(kp, hp, scale=0.1).to(bf)
    bf1, x1, bf2 = f(hidden), f(t, c), f(c).to(bf)
    z, wad = f(t, 64).to(bf), f(growth, 64, scale=0.1).to(bf)
    bad, gad, bbad = f(growth), f(growth), f(growth)
    counts = [fn.launches for fn in (tw.qkv_gemm, tw.proj_ln, tw.mlp,
                                     tw.adapter)]
    q8 = tw.qkv_gemm(xq, wq, bqkv, ws, c=c)
    # exact integer sums, then the epilogue's two roundings
    acc = (xq[:, :c].long() @ wq[:, :c].long().t()).float()
    assert torch.equal(q8, (acc * ws + bqkv).to(bf))
    assert torch.equal(tw.qkv_gemm(xn, wqkv, bqkv, c=c),
                       tw.qkv_gemm_reference(xn, wqkv, bqkv, c=c))
    x1_, x1n = tw.proj_ln(xn, wproj, x, bproj, c=c)
    assert x1_.dtype == torch.float32 and x1n.dtype == bf
    assert (x1n[:, c] == 1).all() and not x1n[:, c + 1:].float().any()
    out = tw.mlp(x1n, w1, w2, bf1, x1, bf2, c=c, hidden=hidden)
    assert tuple(out.shape) == (t, c) and out.dtype == bf
    for prenorm in (False, True):
        a = tw.adapter(z, wad, bad, gad, bbad, c=c, prenorm=prenorm)
        assert torch.equal(a, tw.adapter_reference(
            z, wad, bad, gad, bbad, c=c, prenorm=prenorm))
    assert counts == [fn.launches for fn in (tw.qkv_gemm, tw.proj_ln,
                                             tw.mlp, tw.adapter)]
    with pytest.raises(ValueError):
        tw.qkv_gemm(xn, wq, bqkv, ws, c=c)  # bf16 rows, int8 weights
    with pytest.raises(ValueError):
        tw.mlp(x1n, w1, w2, bf1, x1, bf2, c=200, hidden=hidden)


def test_kernels_a_call():
    """Five kernels a token-parallel block (fc1 and fc2 in one): the W96
    RDSTB 3 x (5 + 5 + 2) + 1 = 37 a call, the pair 10."""
    routes = rb.dstl_routes(96, 48, 3, True)
    assert routes == ["tokens"] * 3
    assert rb.rdstb_kernel_count(routes, True) == 37
    assert rb.rdstb_kernel_count(routes, False) == 34
    assert sp.KERNELS == {"window": 2, "tokens": 10}


@pytest.mark.parametrize("t,c", [(64, 96), (960, 144), (80, 180), (32, 192),
                                 (48, 45)])
def test_x1_order_is_the_accumulator_order(t, c):
    """x1 between the projection's and the MLP's kernels: ``x1_pack`` puts
    (row m, column col) where ``tokwg::x1_at`` says -- block m // 16, piece
    col // 64, 8-column group, row half, lane 4 g + t, pair -- and
    ``x1_unpack`` takes it back."""
    rng = np.random.default_rng(t + c)
    x1 = torch.from_numpy(rng.normal(0, 1, (t, c)).astype(np.float32))
    flat = tw.x1_pack(x1)
    pc = -(-c // 64)
    assert flat.numel() == -(-t // 16) * 16 * 64 * pc
    assert torch.equal(tw.x1_unpack(flat, t, c), x1)
    for m in range(0, t, 7):
        for col in range(0, c, 5):
            blk, r = divmod(m, 16)
            h, g = divmod(r, 8)
            q, cc = divmod(col, 64)
            j, u = divmod(cc, 8)
            tt, e = divmod(u, 2)
            at = ((((blk * pc + q) * 8 + j) * 2 + h) * 32 + 4 * g + tt) * 2
            assert flat[at + e] == x1[m, col]
