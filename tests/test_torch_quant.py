"""The int8 qkv option of the fast block (``rdst_tpu_torch.kernels.quant``
and the ``qkv`` operands of ``kernels.swin_block``) against the JAX
package's ``pallas_quant='qkv'`` on the CPU.

* ``quantize_weight`` bit-equal to JAX's on the committed SwinIR-std
  checkpoint's folded qkv weights (every block), folded by each package
  from the same parameters (the folds are equal too);
* ``quant_rows`` bit-equal to ``_quant_rows`` on the same float32 rows;
  on rows that went through each package's own normalize, the entries
  that differ (rounding ties of float32 sums taken in another order) are
  counted and reported: at most one step each;
* the plain fast body with int8 qkv against the JAX fast kernel in
  interpret mode, shared and per-window bias, 'clamp' and 'stable':
  <= 0.02 relative max (the bar of the bf16 fast block).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.kernels import swin_block as jsb
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_swinir
from rdst_tpu_torch.kernels import quant
from rdst_tpu_torch.kernels import swin_block as sb

REPO = pathlib.Path(__file__).resolve().parents[1]
SNAPSHOT = REPO / "weights" / "swinir_std_40k_best_oasis20_x4.msgpack"
TOL = 0.02


@pytest.fixture(scope="module")
def std_blocks():
    """The 36 blocks' (wqkv, bqkv, g1, b1) of the committed SwinIR-std
    weights, in the JAX layout ((in, out) weights)."""
    sd = export_swinir(mr.read_snapshot(str(SNAPSHOT)))
    out = []
    for i in range(6):
        for k in range(6):
            pre = f"layers.{i}.residual_group.blocks.{k}."
            out.append(tuple(np.array(a, np.float32) for a in (
                sd[pre + "attn.qkv.weight"].T, sd[pre + "attn.qkv.bias"],
                sd[pre + "norm1.weight"], sd[pre + "norm1.bias"])))
    return out


def test_constants_match_jax():
    assert quant.QCLIP == jsb._QCLIP and quant.QX == jsb._QX
    assert quant.mm_quant_groups({"qkv", "conv"}) == \
        jsb.mm_quant_groups({"qkv", "conv"}) == frozenset({"qkv"})


def test_quantize_weight_bit_equal_on_checkpoint(std_blocks):
    """Each package folds LN1's affine and the q scale into the bf16 qkv
    weight (the operand ``_fused_swin_block_jit`` hands to
    ``mm_quant_extras``) and quantizes it: the folds and the int8
    weights and steps are bit-equal, block for block."""
    c, nh = 180, 6
    dt = jnp.bfloat16
    for w, b, g1, b1 in std_blocks:
        zeros = np.zeros(c, np.float32)
        jw, _, _, _ = jsb._fold_fast_weights(
            jnp.asarray(w, dt), jnp.asarray(b, dt), jnp.asarray(g1),
            jnp.asarray(b1), jnp.asarray(zeros), jnp.asarray(zeros),
            jnp.zeros((c, 2 * c), dt), jnp.zeros(2 * c, dt), c,
            (c // nh) ** -0.5, dt)
        tw, _, _, _ = sb.fold_fast_weights(
            torch.from_numpy(w).to(torch.bfloat16),
            torch.from_numpy(b).to(torch.bfloat16), torch.from_numpy(g1),
            torch.from_numpy(b1), torch.from_numpy(zeros),
            torch.from_numpy(zeros), torch.zeros(c, 2 * c, dtype=torch.bfloat16),
            torch.zeros(2 * c, dtype=torch.bfloat16), c, (c // nh) ** -0.5)
        np.testing.assert_array_equal(np.asarray(jw.astype(jnp.float32)),
                                      tw.float().numpy())
        jq, js = jsb.quantize_weight(jw, act_step=1.0 / jsb._QX)
        q = quant.qkv_quant(tw)
        np.testing.assert_array_equal(np.asarray(jq), q.wq.numpy())
        np.testing.assert_array_equal(np.asarray(js).reshape(-1),
                                      q.ws.numpy())
        assert q.wq.dtype == torch.int8 and q.ws.dtype == torch.float32


def test_quant_rows_bit_equal():
    """Same float32 rows in: the same int8 rows out, ties (x.5 steps)
    included, as both round half to even."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.5, (4096, 180)).astype(np.float32)
    ties = (np.arange(-260, 261) / 2.0 / jsb._QX).astype(np.float32)
    for rows in (x, ties[None]):
        np.testing.assert_array_equal(
            np.asarray(jsb._quant_rows(jnp.asarray(rows), jsb._QX)),
            quant.quant_rows(torch.from_numpy(rows), quant.QX).numpy())


def test_quant_rows_after_each_normalize(capsys):
    """Rows normalized by each package (one-pass moments in float32, sums
    in another order) and quantized: the entries that differ are ties
    moved by an ulp; counted and reported, each one step apart."""
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 1, (8192, 180)) * rng.uniform(0.2, 3, (8192, 1))
         + rng.normal(0, 1, (8192, 1))).astype(np.float32)
    jq = np.asarray(jsb._quant_rows(jsb._normalize(jnp.asarray(x)),
                                    jsb._QX)).astype(np.int32)
    tq = quant.quant_rows(sb.normalize(torch.from_numpy(x)),
                          quant.QX).numpy().astype(np.int32)
    diff = np.abs(jq - tq)
    with capsys.disabled():
        print(f"\nint8 rows after each package's normalize: "
              f"{int((diff > 0).sum())} of {diff.size} entries differ")
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def _params(rng, c, hid):
    def arr(*s, scale=0.5):
        return rng.normal(0, scale, s).astype(np.float32)

    return [arr(c, 3 * c, scale=c ** -0.5), arr(3 * c, scale=0.1),
            arr(c, c, scale=c ** -0.5), arr(c, scale=0.1),
            1 + 0.1 * arr(c), 0.1 * arr(c), 1 + 0.1 * arr(c), 0.1 * arr(c),
            arr(c, hid, scale=c ** -0.5), arr(hid, scale=0.1),
            arr(hid, c, scale=hid ** -0.5), arr(c, scale=0.1)]


@pytest.mark.parametrize("softmax", ["clamp", "stable"])
@pytest.mark.parametrize("per_window", [False, True],
                         ids=["shared_bias", "per_window_bias"])
def test_plain_fast_body_with_qkv_matches_jax(monkeypatch, softmax,
                                              per_window):
    """The plain version with int8 qkv (``plan_fast_block(quant={'qkv'})``
    on a CPU tensor) against ``fused_swin_block(quant={'qkv'},
    interpret=True)``: C = 24, 2 heads, window 8, 4 windows per image, 2
    images."""
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", softmax)
    clear_kernel_caches()
    rng = np.random.default_rng(2)
    c, nh, n, nw = 24, 2, 64, 4
    p = _params(rng, c, 2 * c)
    bias = rng.normal(0, 1, ((nh * nw if per_window else nh), n, n)
                      ).astype(np.float32)
    x = rng.normal(0, 1, (2 * nw, n, c)).astype(np.float32)
    dt = jnp.bfloat16
    jp = [jnp.asarray(a) if i in (4, 5, 6, 7) else jnp.asarray(a, dt)
          for i, a in enumerate(p)]
    want = np.asarray(jsb.fused_swin_block(
        jnp.asarray(x, dt), *jp, jnp.asarray(bias, dt), num_heads=nh,
        windows_per_image=nw, interpret=True,
        quant=frozenset({"qkv"})).astype(jnp.float32))
    plan = sb.plan_fast_block([torch.from_numpy(a) for a in p],
                              torch.from_numpy(bias).to(torch.bfloat16),
                              num_heads=nh, quant=frozenset({"qkv"}))
    assert plan.qkv is not None and plan.qkv_layout == ()
    before = sb.run_fast_block.launches
    got = sb.run_fast_block(torch.from_numpy(x).to(torch.bfloat16), plan,
                            num_heads=nh, windows_per_image=nw,
                            softmax=softmax).float().numpy()
    assert sb.run_fast_block.launches == before  # CPU: the plain version
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_unported_groups_raise():
    with pytest.raises(NotImplementedError, match="int8 'mlp'"):
        quant.check_ported({"qkv", "mlp"})
    assert quant.check_ported({"qkv", "conv"} - {"conv"}) == {"qkv"}
