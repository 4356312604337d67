"""The bf16 slice as a whole: the port's bfloat16 ``RDSTSR`` against the
JAX package's bfloat16 model on the CPU (JAX kernels in interpret mode,
``RDST_TPU_PALLAS_INTERPRET=1``, as ``tests/test_kernels.py`` runs them).

* ``test_kernels.py``'s narrow model (2 RDSTBs, embed 12, growth 6, 3
  heads, window 8) on seeded weights, in each kernel mode (rdstb, pair,
  swin, and off = the JAX XLA bf16 path), same mode on both sides:
  <= 0.02 relative max error (``test_kernels.py:394``'s bar for the
  kernel paths; bf16 roundings at the same places, summation order and
  the approximate reciprocal differ);
* the shipped flagship (RDST-E1 x4, its committed weights, softmax
  'auto' -> clamp) at full width on one 40x32 slice, rdstb path against
  the JAX rdstb path: <= 0.02; and against the JAX float32 path within
  ``test_kernels.py:394-397``'s bars (< 0.05 max, < 0.005 mean,
  relative). The bf16-vs-f32 PSNR of both packages is printed.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.models.rdst import RDSTSR as JaxRDSTSR
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import RDSTSR, set_kernel_mode
from test_torch_model import _random_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini")
SNAPSHOT = REPO / "weights" / "rdst_e1_40k_best_oasis20_x4.msgpack"
TOL = 0.02
SMALL = dict(in_chans=1, sr_scale=2, embed_dim=12, dense_layer_depths=(2, 2),
             num_heads=(3, 3), window_size=(8, 8), rdb_depths=(2, 2),
             mlp_ratio=2.0, growth_rate=6, build_resolution=(16, 16))
ROUTES = {"rdstb": "fused_rdstb", "pair": "fused_swin_pair",
          "swin": "fused_swin_block", "off": "plain"}


def rel(got, want):
    d = np.abs(got - want)
    scale = np.abs(want).max()
    return float(d.max() / scale), float(d.mean() / scale)


def psnr(a, b):
    return float(10 * np.log10(1.0 / np.mean((a - b) ** 2)))


@pytest.fixture(scope="module")
def small_params():
    model = JaxRDSTSR(**SMALL, dtype=jnp.bfloat16)
    x = np.zeros((1, 16, 16, 1), np.float32)
    init = jax.jit(lambda k, x: model.init(k, x))(jax.random.PRNGKey(0), x)
    return _random_tree(init, 21)


@pytest.mark.parametrize("mode", ["rdstb", "pair", "swin", "off"])
def test_small_bf16_model_matches_jax(monkeypatch, small_params, mode):
    x = np.random.default_rng(5).normal(0, 0.3, (1, 16, 16, 1)).astype(
        np.float32)
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS", "0" if mode == "off" else mode)
    monkeypatch.delenv("RDST_TPU_PALLAS_SOFTMAX", raising=False)
    clear_kernel_caches()
    jm = JaxRDSTSR(**SMALL, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(
        small_params, jnp.asarray(x).astype(jnp.bfloat16)).astype(
            jnp.float32))
    clear_kernel_caches()

    model = RDSTSR(**SMALL, dtype=torch.bfloat16)
    sd = export_rdstsr(small_params, model.mean, model.std)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    model.eval()
    assert set_kernel_mode(model, "" if mode == "off" else mode,
                           "stable") == [ROUTES[mode]] * 2
    counts = [f.launches for f in (rdstb_block.run_rdstb,
                                   swin_pair.run_swin_pair,
                                   swin_block.run_fast_block)]
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 32, 1)
    assert counts == [f.launches for f in (rdstb_block.run_rdstb,
                                           swin_pair.run_swin_pair,
                                           swin_block.run_fast_block)]
    assert rel(got.float().numpy(), want)[0] <= TOL


def test_flagship_bf16_full_width_matches_jax(monkeypatch, capsys):
    data = SNAPSHOT.read_bytes()
    x = np.random.default_rng(6).random((1, 40, 32, 1), dtype=np.float32)
    flax_params = serialization.msgpack_restore(data)

    # JAX: f32 XLA path, then the bf16 rdstb path in interpret mode
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    jm32 = jax_build(JaxParams(CONFIG))
    want32 = np.asarray(jax.jit(lambda p, x: jm32.apply(p, x, 4.0))(
        flax_params, x))
    monkeypatch.setenv("RDST_TPU_PALLAS", "rdstb")
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "clamp")  # auto @ 25.412
    clear_kernel_caches()
    jm16 = jax_build(JaxParams(CONFIG), dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(lambda p, x: jm16.apply(p, x, 4.0))(
        flax_params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    clear_kernel_caches()

    p = ParametersLoader(CONFIG)
    p.set("well_trained_single_scale_model_g", str(SNAPSHOT))
    model = build_generator(p, dtype=torch.bfloat16)
    assert model.kernel_mode == "rdstb" and model.softmax == "clamp"
    assert model.routes == ["fused_rdstb"] * 8
    sd = export_rdstsr(mr.msgpack_restore(data), model.mean, model.std)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    assert got.shape == want16.shape == (1, 160, 128, 1)
    assert np.isfinite(got).all()
    assert rel(got, want16)[0] <= TOL
    err_max, err_mean = rel(got, want32)
    assert err_max < 0.05 and err_mean < 0.005
    jmax, jmean = rel(want16, want32)
    with capsys.disabled():
        print(f"\nflagship bf16 vs f32 on one 40x32 slice: port PSNR "
              f"{psnr(got, want32):.2f} dB (rel max {err_max:.4f}, mean "
              f"{err_mean:.5f}); JAX PSNR {psnr(want16, want32):.2f} dB "
              f"(rel max {jmax:.4f}, mean {jmean:.5f}); port vs JAX bf16 "
              f"rel max {rel(got, want16)[0]:.4f}")


def test_pair_mode_refuses_odd_depth():
    """A layer whose blocks do not come in pairs raises when the model is
    built in mode 'pair', naming the mode to choose instead."""
    model = RDSTSR(**dict(SMALL, dense_layer_depths=(3, 3)),
                   dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pallas_kernels='swin'"):
        set_kernel_mode(model, "pair")


@pytest.mark.parametrize("mode,instead", [("rdstb", "pair"),
                                           ("pair", "swin"), ("swin", "off")])
def test_modes_refuse_widths_the_kernels_do_not_take(mode, instead):
    """Widths past the kernels' channels (embed 96 growing by 102: 96 and
    198, past the pair and RDSTB kernels' 128 and the fast block's 192)
    raise when the model is built in a kernel mode, naming the mode to
    choose instead; the plain path builds."""
    wide = dict(SMALL, embed_dim=96, growth_rate=102, num_heads=(6, 6))
    model = RDSTSR(**wide, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"pallas_kernels='{instead}'"):
        set_kernel_mode(model, mode)
    assert set_kernel_mode(model, "") == ["plain", "plain"]


@pytest.mark.parametrize("mode", ["rdstb", "pair", "swin"])
def test_kernel_plans_follow_weight_updates(small_params, mode):
    """The folded weights a kernel route keeps on its module are rebuilt
    when a parameter changes in place (``load_state_dict``, ``copy_``):
    after an update the model gives what a freshly built model gives."""
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 0.3, (1, 16, 16, 1)).astype(np.float32))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_rdstsr(
        small_params).items()}

    def build(state):
        m = RDSTSR(**SMALL, dtype=torch.bfloat16)
        m.load_state_dict(state)
        set_kernel_mode(m.eval(), mode, "stable")
        return m

    model = build(sd)
    with torch.inference_mode():
        before = model(x)
    changed = dict(sd)
    key = "body.0.body.0.body.blocks.1.attn.qkv.weight"
    changed[key] = sd[key] * 1.5
    model.load_state_dict(changed)
    fresh_model = build(changed)
    with torch.inference_mode():
        after = model(x)
        fresh = fresh_model(x)
        # a model built under inference_mode (parameters without a
        # version counter) runs its kernel route as well
        built_inside = build(changed)(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh) and torch.equal(built_inside, fresh)
