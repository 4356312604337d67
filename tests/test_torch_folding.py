"""``rdst_tpu_torch.data.folding.ImageFolder`` against
``rdst_tpu.data.folding.ImageFolder`` on the CPU: the padding rule, the
patch grid and row-major order, ``unfold`` and ``fold`` on seeded inputs
(within 1e-6), and ``fold(unfold(x))`` giving ``x`` back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.data.folding import ImageFolder as JaxFolder
from rdst_tpu_torch.data.folding import ImageFolder

CASES = [
    # (N, H, W, C), patch, stride
    ((2, 18, 14, 1), 8, 4),
    ((1, 40, 32, 1), 24, 12),  # E1's LR slice, tiled at stride 12
    ((1, 40, 32, 1), 24, 24),  # a padded grid without overlap
    ((3, 10, 8, 2), 4, 4),  # exact tiling
    ((2, 7, 9, 3), (3, 4), (2, 3)),  # rectangular patches and strides
    ((1, 160, 128, 1), 96, 48),  # E1's HR grid at stride 12
]


@pytest.mark.parametrize("shape,patch,stride", CASES)
def test_folder_matches_jax(shape, patch, stride):
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape, dtype=np.float32)
    port, ref = ImageFolder(shape, patch, stride), JaxFolder(shape, patch, stride)
    assert port.padding == ref.padding and port.num_patches == ref.num_patches
    np.testing.assert_array_equal(port.hs, ref.hs)
    np.testing.assert_array_equal(port.ws, ref.ws)
    got = port.unfold(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.unfold(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    patches = rng.random(want.shape, dtype=np.float32)
    got = port.fold(torch.from_numpy(patches)).numpy()
    want = np.asarray(ref.fold(jnp.asarray(patches)))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    back = port.fold(port.unfold(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-6)
