"""The port's periodized 2D DWT (``rdst_tpu_torch.nn.wavelet``) against
``rdst_tpu.nn.wavelet`` on the CPU: ``dwt2`` / ``idwt2`` / ``wavedec2`` /
``waverec2`` for haar, db1 and db2 on seeded NHWC input (1e-6 absolute;
the sums differ only in order), perfect reconstruction in float32
(1e-5), the bf16 transforms against JAX's bf16 ones (one bf16 rounding,
relative 1e-2), and an unknown wavelet refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.nn import wavelet as jw
from rdst_tpu_torch.nn import wavelet as tw

WAVELETS = ("haar", "db1", "db2")


def _x(shape=(2, 12, 8, 3), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", WAVELETS)
def test_dwt2_and_idwt2_match_jax(name):
    x = _x()
    jl, jb = jw.dwt2(jnp.asarray(x), name)
    tl, tb = tw.dwt2(torch.from_numpy(x), name)
    assert tl.shape == (2, 6, 4, 3) and tb.shape == (2, 6, 4, 3, 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    jr = jw.idwt2(jl, jb, name)
    tr = tw.idwt2(tl, tb, name)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("name", ("haar", "db2"))
def test_wavedec2_and_waverec2_match_jax(name):
    x = _x((1, 16, 24, 2), seed=1)
    jl, jc = jw.wavedec2(jnp.asarray(x), name, level=3)
    tl, tc = tw.wavedec2(torch.from_numpy(x), name, level=3)
    assert [c.shape[1:3] for c in tc] == [(8, 12), (4, 6), (2, 3)]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(tw.waverec2(tl, tc, name).numpy(), x,
                               atol=1e-5)


@pytest.mark.parametrize("name", ("haar", "db2"))
def test_bf16_transforms_match_jax(name):
    x = _x((1, 8, 8, 4), seed=2)
    jl, jb = jw.dwt2(jnp.asarray(x).astype(jnp.bfloat16), name)
    tl, tb = tw.dwt2(torch.from_numpy(x).to(torch.bfloat16), name)
    assert tl.dtype == tb.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(jb.astype(jnp.float32))).max())
    for j, t in ((jl, tl), (jb, tb)):
        d = np.abs(t.float().numpy() - np.asarray(j.astype(jnp.float32)))
        assert d.max() <= 1e-2 * scale
    jr = jw.idwt2(jl, jb, name).astype(jnp.float32)
    tr = tw.idwt2(tl, tb, name)
    assert tr.dtype == torch.bfloat16
    d = np.abs(tr.float().numpy() - np.asarray(jr))
    assert d.max() <= 1e-2 * float(np.abs(np.asarray(jr)).max())


def test_unknown_wavelet_raises():
    with pytest.raises(ValueError, match="db4"):
        tw.dwt2(torch.zeros(1, 4, 4, 1), "db4")
