"""The RDSTB kernel's port: ``rdst_tpu_torch.kernels.rdstb_block`` against
``rdst_tpu.kernels.rdstb_block.fused_rdstb`` (bf16, interpret mode, as
``tests/test_kernels.py`` runs it).

* the plain version (the wrapper's CPU path) vs the JAX kernel at C0 = 12,
  growth 6, 3 DSTLs, post- and pre-norm adapters, and at the flagship
  width (C0 = 60, growth 30, 6 heads, one 40x32 image) with the shipped
  flagship weights of its first RDSTB: <= 0.02 relative max error
  (``test_kernels.py``'s bar for this kernel; 3 DSTLs of bf16 blocks,
  adapters and the conv round at the same places in both, so only
  summation order and the approximate reciprocal differ; measured:
  <= 0.007). The flagship's adapters are pre-norm (LN(C) then Dense);
* the adapter fold against ``_fused_rdstb_impl``'s on the flagship's
  adapters: bitwise after the bf16 casts, the f32 folded bias within
  1e-6 relative; the post-norm adapter's casts, bitwise;
* the gate: what the kernel does not take raises, nothing launches.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import rdstb_block as jax_rb
from rdst_tpu.nn.swin import (relative_position_index as jax_rel_index,
                              shift_attention_mask as jax_mask)
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.kernels import rdstb_block as rb

TOL = 0.02
WS, N = 8, 64
SNAPSHOT = (pathlib.Path(__file__).resolve().parents[1] / "weights"
            / "rdst_e1_40k_best_oasis20_x4.msgpack")


def _bias(table, nh, h, w, shifted):
    rel = table[jax_rel_index(WS, WS).reshape(-1)].reshape(N, N, nh)
    rel = rel.transpose(2, 0, 1)
    if not shifted:
        return np.ascontiguousarray(rel, np.float32)
    nw = (h // WS) * (w // WS)
    return np.ascontiguousarray(
        (rel[:, None] + jax_mask(h, w, WS, WS // 2)[None]).reshape(
            nh * nw, N, N), np.float32)


def random_rdstb(c0, growth, nb, nh, h, w, prenorm, seed):
    """Seeded RDSTB weights in the JAX ``fused_rdstb`` layout."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.2):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    dstls, c = [], c0
    for _ in range(nb):
        blocks = []
        for shifted in (False, True):
            hid = 2 * c
            params = [f(c, 3 * c, scale=c ** -0.5), f(3 * c),
                      f(c, c, scale=c ** -0.5), f(c), 1.0 + f(c), f(c),
                      1.0 + f(c), f(c), f(c, hid, scale=c ** -0.5), f(hid),
                      f(hid, c, scale=hid ** -0.5), f(c)]
            blocks.append((params, _bias(f((2 * WS - 1) ** 2, nh, scale=1.0),
                                         nh, h, w, shifted)))
        ca = c if prenorm else growth
        dstls.append({"blocks": blocks,
                      "adapter": (f(c, growth, scale=c ** -0.5), f(growth),
                                  1.0 + f(ca), f(ca))})
        c += growth
    return dstls, f(3, 3, c, c0, scale=(9 * c) ** -0.5), f(c0)


def flagship_rdstb(h, w):
    """The first RDSTB of the shipped flagship snapshot, JAX layout (its
    adapters are pre-norm: tail_0 the LN(C), tail_1 the Dense)."""
    tree = mr.read_snapshot(str(SNAPSHOT))["params"]["body_0"]
    dstls = []
    for d in range(3):
        layer = tree[f"body_{d}"]
        blocks = []
        for k in range(2):
            blk = layer["body"][f"blocks_{k}"]
            a = blk["attn"]
            params = [a["qkv"]["kernel"], a["qkv"]["bias"], a["proj"]["kernel"],
                      a["proj"]["bias"], blk["norm1"]["scale"],
                      blk["norm1"]["bias"], blk["norm2"]["scale"],
                      blk["norm2"]["bias"], blk["mlp"]["fc1"]["kernel"],
                      blk["mlp"]["fc1"]["bias"], blk["mlp"]["fc2"]["kernel"],
                      blk["mlp"]["fc2"]["bias"]]
            table = np.asarray(a["relative_position_bias_table"])
            blocks.append(([np.asarray(p, np.float32) for p in params],
                           _bias(table, 6, h, w, k == 1)))
        ln, dense = layer["tail_0"], layer["tail_1"]
        dstls.append({"blocks": blocks, "adapter": tuple(
            np.asarray(v, np.float32) for v in (
                dense["kernel"], dense["bias"], ln["scale"], ln["bias"]))})
    conv = tree["conv"]["conv"]
    return (dstls, np.asarray(conv["kernel"], np.float32),
            np.asarray(conv["bias"], np.float32))


def run_both(monkeypatch, x, dstls, ck, cb, *, nh, h, w, growth, prenorm,
             softmax):
    if softmax == "stable":
        monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    bf = jnp.bfloat16
    jd = [{"blocks": [([jnp.asarray(p) for p in params],
                       jnp.asarray(bias).astype(bf))
                      for params, bias in d["blocks"]],
           "adapter": tuple(jnp.asarray(a) for a in d["adapter"])}
          for d in dstls]
    kw = dict(num_heads=nh, x_size=(h, w), window_size=WS, shift=WS // 2,
              growth=growth, adapter_prenorm=prenorm)
    want = np.asarray(jax_rb.fused_rdstb(
        jnp.asarray(x).astype(bf), jd, jnp.asarray(ck), jnp.asarray(cb),
        interpret=True, quant=frozenset(), **kw).astype(jnp.float32))
    clear_kernel_caches()
    t = torch.from_numpy
    td = [{"blocks": [([t(p) for p in params], t(bias).bfloat16())
                      for params, bias in d["blocks"]],
           "adapter": tuple(t(a) for a in d["adapter"])} for d in dstls]
    before = rb.run_rdstb.launches
    got = rb.fused_rdstb(t(x).bfloat16(), td, t(ck), t(cb), softmax=softmax,
                         **kw)
    assert rb.run_rdstb.launches == before  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    return got.float().numpy(), want


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("prenorm", [False, True], ids=["postnorm", "prenorm"])
def test_reference_matches_jax_rdstb(monkeypatch, prenorm):
    h, w = 16, 24
    dstls, ck, cb = random_rdstb(12, 6, 3, 3, h, w, prenorm, seed=7)
    x = np.random.default_rng(8).normal(0, 0.5, (2, h * w, 12)).astype(
        np.float32)
    got, want = run_both(monkeypatch, x, dstls, ck, cb, nh=3, h=h, w=w,
                         growth=6, prenorm=prenorm, softmax="stable")
    assert rel_err(got, want) <= TOL


def test_flagship_width_rdstb_matches_jax(monkeypatch):
    """One flagship RDSTB (C0 = 60, growth 30, widths 60/90/120, 6 heads)
    with its trained weights on one 40x32 image, in the flagship's
    resolved softmax variant."""
    h, w = 40, 32
    dstls, ck, cb = flagship_rdstb(h, w)
    x = np.random.default_rng(9).normal(0, 1.0, (1, h * w, 60)).astype(
        np.float32)
    got, want = run_both(monkeypatch, x, dstls, ck, cb, nh=6, h=h, w=w,
                         growth=30, prenorm=True, softmax="clamp")
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= TOL


def test_adapter_fold_matches_jax():
    """``prep_adapter`` against the fold inside ``_fused_rdstb_impl``
    (:460-476): the flagship's pre-norm adapters (the LN(C) affine folded
    into the Dense), and a post-norm adapter (casts only)."""
    dstls, _, _ = flagship_rdstb(40, 32)
    bf, f32 = jnp.bfloat16, jnp.float32
    for d in dstls:
        wa, ba, ga, bba = (jnp.asarray(a) for a in d["adapter"])
        # _fused_rdstb_impl's pre-norm fold, verbatim
        wa_f = ga.astype(f32)[:, None] * wa.astype(bf).astype(f32)
        ba_f = bba.astype(f32) @ wa.astype(bf).astype(f32) \
            + ba.astype(bf).astype(f32)
        got = rb.prep_adapter(*[torch.from_numpy(a) for a in d["adapter"]],
                              True)
        assert np.array_equal(got.w.float().numpy(),
                              np.asarray(wa_f.astype(bf).astype(f32)))
        ba_f = np.asarray(ba_f)
        assert np.abs(got.b.numpy() - ba_f).max() <= 1e-6 * np.abs(
            ba_f).max()
    rng = np.random.default_rng(10)
    c, g = 90, 30
    post = [rng.normal(0, 0.1, s).astype(np.float32)
            for s in ((c, g), (g,), (g,), (g,))]
    got = rb.prep_adapter(*[torch.from_numpy(a) for a in post], False)
    wa, ba, ga, bba = (jnp.asarray(a) for a in post)
    want = (wa.astype(bf), ba.astype(bf), ga.astype(f32), bba.astype(f32))
    for g_, w_ in zip(got, want):
        assert np.array_equal(g_.float().numpy(), np.asarray(w_.astype(f32)))


def test_conv_rows_are_tap_major():
    k = torch.arange(3 * 3 * 5 * 2, dtype=torch.float32).reshape(3, 3, 5, 2)
    rows = rb.conv_rows(k)
    assert rows.shape == (45, 2)
    assert torch.equal(rows[(1 * 3 + 2) * 5 + 4].float(), k[1, 2, 4])


@pytest.mark.parametrize("args,ok", [
    ((64, 60, 30, 3, 6, 2.0), True),    # the flagship RDSTB
    ((64, 12, 6, 3, 3, 2.0), True),
    ((64, 60, 30, 5, 6, 2.0), False),   # 5 DSTLs: over the kernel's 4
    ((49, 60, 30, 3, 6, 2.0), False),   # window 7
    ((64, 96, 54, 3, 6, 2.0), False),   # widths up to 204 > 192
    ((64, 96, 48, 3, 6, 2.0), True),    # RDST-W96: C = 96 / 144 / 192
])
def test_rdstb_kernel_gate(args, ok):
    assert rb.rdstb_kernel_supports(*args) is ok


def test_rdstb_wrapper_refuses_geometry_without_launch():
    """An RDSTB at window 4 on a 12x20 image with a width the kernel does
    not take raises before any device work; nothing launches."""
    h, w = 16, 24
    dstls, ck, cb = random_rdstb(12, 6, 3, 3, h, w, False, seed=11)
    t = torch.from_numpy
    td = [{"blocks": [([t(p) for p in params], t(bias).bfloat16())
                      for params, bias in d["blocks"]],
           "adapter": tuple(t(a) for a in d["adapter"])} for d in dstls]
    x = torch.zeros(1, h * w, 12, dtype=torch.bfloat16)
    before = rb.run_rdstb.launches
    with pytest.raises(ValueError, match="does not take"):
        rb.fused_rdstb(x, td, t(ck), t(cb), num_heads=3, x_size=(h, w),
                       window_size=WS, shift=WS, growth=6)
    assert rb.run_rdstb.launches == before
