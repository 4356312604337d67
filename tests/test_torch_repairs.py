"""Five places where ``rdst_tpu`` served and the port failed (ROADMAP
Queue C 1-5), each held against the JAX package on the CPU:

1. the f32 kernel route on an image of one window (LR 5x5, 8x8): the
   shifted bias kept the permuted strides of the relative-position
   bias and the wrapper refused it;
2. the bf16 pair route on a padded one-window image: the pair wrapper
   was handed a non-contiguous window partition;
3. LR sides of 4 or less: torch's reflect pad refuses a pad >= the side,
   ``jnp.pad(mode='reflect')`` reflects again;
4. f32 routes are checked when the model is built (W96: C = 192 needs
   262,912 B of shared memory), not at the first ``predict``;
5. ``pallas_quant`` in f32 is dropped, as the JAX precise path drops
   it; bf16 still raises.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.serving import export as jax_export
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import pad_to_window_multiple
from rdst_tpu_torch.serving import export

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini")
WEIGHTS = str(REPO / "weights" / "rdst_e1_40k_best_oasis20_x4.msgpack")
W96 = str(REPO / "config_files" / "rdst_w96_40k_oasis20_x4.ini")
TOL = 1e-4  # f32: the port's kernel path vs the JAX XLA path


def _paras(cls=ParametersLoader, **overrides):
    p = cls(CONFIG)
    p.set("well_trained_single_scale_model_g", WEIGHTS)
    for k, v in overrides.items():
        p.set(k, v)
    return p


@pytest.fixture(scope="module")
def jax_live():
    return jax_export.LiveModel(_paras(JaxParams), max_batch=1)


@pytest.fixture(scope="module")
def live():
    return export.LiveModel(_paras(), max_batch=1, device="cpu")


def _lr(side):
    return np.random.default_rng(side).random((1, side, side, 1),
                                              dtype=np.float32)


@pytest.mark.parametrize("side", [5, 8])
def test_f32_kernel_route_serves_one_window(live, jax_live, side):
    assert live.manifest["routes"] == ["fused_swin_block"] * 8
    x = _lr(side)
    got = live.predict(x, 4.0)
    want = np.asarray(jax_live.predict(x, 4.0))
    assert got.shape == want.shape == (1, 4 * side, 4 * side, 1)
    assert float(np.abs(got - want).max()) <= TOL


def test_bf16_pair_route_serves_padded_one_window():
    live16 = export.LiveModel(_paras(inference_dtype="bfloat16",
                                     pallas_kernels="pair"),
                              max_batch=1, device="cpu")
    assert live16.manifest["routes"] == ["fused_swin_pair"] * 8
    live32 = export.LiveModel(_paras(pallas_kernels="off"), max_batch=1,
                              device="cpu")
    x = _lr(5)
    got, want = live16.predict(x, 4.0), live32.predict(x, 4.0)
    assert got.shape == (1, 20, 20, 1) and np.isfinite(got).all()
    # bf16 against f32 (test_kernels.py:394-397's bars)
    d = np.abs(got - want) / np.abs(want).max()
    assert d.max() < 0.05 and d.mean() < 0.005


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (3, 3), (4, 4), (4, 1),
                                 (5, 2)])
def test_pad_reflects_like_jnp(h, w):
    x = np.random.default_rng(h * 10 + w).random((2, h, w, 3),
                                                  dtype=np.float32)
    got, hw = pad_to_window_multiple(torch.from_numpy(x), 8)
    ph, pw = (-h) % 8, (-w) % 8
    want = np.asarray(jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)),
                              mode="reflect"))
    assert hw == (h, w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", [3, 4])
def test_small_sides_serve_like_jax(live, jax_live, side):
    x = _lr(side)
    got = live.predict(x, 4.0)
    want = np.asarray(jax_live.predict(x, 4.0))
    assert got.shape == want.shape == (1, 4 * side, 4 * side, 1)
    assert float(np.abs(got - want).max()) <= TOL


def test_f32_routes_checked_at_build():
    p = ParametersLoader(W96)
    p.set("pallas_quant", "off")
    with pytest.raises(ValueError, match="pallas_kernels='off'") as e:
        build_generator(p)
    assert "262912" in str(e.value)
    p.set("pallas_kernels", "off")
    assert build_generator(p).routes == ["plain"] * 8


def test_f32_serving_drops_int8(monkeypatch):
    monkeypatch.setenv("RDST_TORCH_QUANT", "")
    quant = export.LiveModel(_paras(pallas_quant="qkv"), max_batch=1,
                             device="cpu")
    plain = export.LiveModel(_paras(), max_batch=1, device="cpu")
    x = _lr(8)
    np.testing.assert_array_equal(quant.predict(x, 4.0),
                                  plain.predict(x, 4.0))
    with pytest.raises(NotImplementedError, match="int8"):
        export.build_serving_model(
            _paras(pallas_quant="qkv", inference_dtype="bfloat16"),
            device="cpu")
