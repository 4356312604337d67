"""Port of the fused Swin block: ``rdst_tpu_torch.kernels.swin_block``.

The port's plain version (the CPU path of the wrapper, and the oracle the
CUDA kernel is held against on the card) must compute what the JAX
``fused_swin_block`` computes in its f32 precise branch, here run in
interpret mode as ``tests/test_kernels.py`` runs it. Inputs come from a
numpy seed and go to both packages. Tolerance: 1e-5 max abs (f32, the
two differ only in summation order and the JAX package's polynomial
erf, abs err 1.5e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.kernels import swin_block as jax_sb
from rdst_tpu.nn.swin import (relative_position_index as jax_rel_index,
                              shift_attention_mask as jax_mask)
from rdst_tpu_torch.kernels import swin_block as sb
from rdst_tpu_torch.kernels import window_attention as wa

TOL = 1e-5
N, NH, NW, WS = 64, 6, 20, 8  # flagship: window 8, 6 heads, 20 windows/slice


def _block_inputs(c: int, shifted: bool, images: int = 2, seed: int = 0):
    """Seeded block inputs in the JAX layout (weights (in, out)); the bias
    is built like ``SwinTransformerBlock._kernel_inputs`` for a 40x32
    slice: rel-pos (+ shift mask) per window, or shared."""
    rng = np.random.default_rng(seed)
    hid = 2 * c

    def f(*shape, scale=0.2):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    table = f((2 * WS - 1) ** 2, NH, scale=1.0)
    idx = jax_rel_index(WS, WS).reshape(-1)
    rel = table[idx].reshape(N, N, NH).transpose(2, 0, 1)
    if shifted:
        mask = jax_mask(40, 32, WS, WS // 2)
        bias = (rel[:, None] + mask[None]).reshape(NH * NW, N, N)
    else:
        bias = rel
    # weights at 1/sqrt(fan_in), as trained layers keep them: activations
    # stay O(1), the scale the absolute tolerance is stated for
    x = f(images * NW, N, c, scale=1.0)
    wc, wh = c ** -0.5, hid ** -0.5
    params = [f(c, 3 * c, scale=wc), f(3 * c), f(c, c, scale=wc), f(c),
              1.0 + f(c), f(c), 1.0 + f(c), f(c),
              f(c, hid, scale=wc), f(hid), f(hid, c, scale=wh), f(c)]
    return x, params, np.ascontiguousarray(bias, np.float32)


@pytest.mark.parametrize("shifted", [False, True], ids=["shared", "shifted"])
@pytest.mark.parametrize("c", [60, 90, 120])
def test_reference_matches_jax_precise_block(c, shifted):
    x, params, bias = _block_inputs(c, shifted)
    want = np.asarray(jax_sb.fused_swin_block(
        jnp.asarray(x), *[jnp.asarray(p) for p in params], jnp.asarray(bias),
        num_heads=NH, windows_per_image=NW, interpret=True))
    got = sb.swin_block_reference(
        torch.from_numpy(x), *[torch.from_numpy(p) for p in params],
        torch.from_numpy(bias), num_heads=NH, windows_per_image=NW).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("shifted", [False, True], ids=["shared", "shifted"])
def test_cpu_wrapper_takes_plain_version_without_launch(shifted):
    x, params, bias = _block_inputs(60, shifted, seed=1)
    args = [torch.from_numpy(a) for a in (x, *params, bias)]
    before = sb.fused_swin_block.launches
    got = sb.fused_swin_block(*args, num_heads=NH, windows_per_image=NW)
    ref = sb.swin_block_reference(*args, num_heads=NH, windows_per_image=NW)
    assert torch.equal(got, ref)
    assert sb.fused_swin_block.launches == before


def test_missing_qkv_bias_is_zero_bias():
    x, params, bias = _block_inputs(60, False, seed=2)
    args = [torch.from_numpy(a) for a in (x, *params, bias)]
    zero = list(args)
    zero[2] = torch.zeros_like(args[2])
    none = list(args)
    none[2] = None
    kw = dict(num_heads=NH, windows_per_image=NW)
    assert torch.equal(sb.fused_swin_block(*none, **kw),
                       sb.fused_swin_block(*zero, **kw))


def test_bias_window_mismatch_raises():
    x, params, bias = _block_inputs(60, True, seed=3)
    args = [torch.from_numpy(a) for a in (x, *params, bias)]
    with pytest.raises(ValueError, match="per-window"):
        sb.swin_block_reference(*args, num_heads=NH, windows_per_image=10)


@pytest.mark.parametrize("c", [60, 90, 120])
def test_kernel_takes_flagship_geometry(c):
    assert sb.f32_kernel_supports(N, c, NH, 2 * c)
    assert sb.f32_smem_bytes(N, c, NH) <= sb.H100_SMEM_OPTIN


def test_kernel_shared_memory_budget():
    # a GEMM tile: 3 stages of BM x (16 + 4) A floats and both TF32 parts
    # of a 16 x (BN + 8) weight slice, or the BM x (BN + 4) accumulator
    assert sb.f32_tile_smem_bytes(64, 192) == 4 * 3 * (64 * 20 + 2 * 16 * 200)
    assert sb.f32_tile_smem_bytes(128, 128) == 4 * 3 * (128 * 20 + 2 * 16 * 136)
    assert sb.f32_tile_smem_bytes(64, 64) == 4 * 3 * (64 * 20 + 2 * 16 * 72)
    # one (window, head): q^T, k^T (hd rows of N + 4), v, P^T (N + 4)
    assert sb.f32_attn_smem_bytes(64, 32) == 4 * (2 * 32 * 68 + 64 * 32
                                                  + 64 * 68)
    # the widest tile bounds every width the kernel takes, W96's and
    # SwinIR-std's included
    for c in (60, 90, 120, 180, 192):
        assert sb.f32_smem_bytes(64, c, 6) == 92160 <= sb.H100_SMEM_OPTIN


@pytest.mark.parametrize("n,c,nh,hid", [
    (49, 60, 6, 120),    # window 7: N does not divide the thread count
    (64, 61, 1, 122),    # odd C
    (64, 198, 6, 396),   # C = 198 > 192: the row kernels keep 6 values a lane
    (64, 66, 2, 132),    # head dim 33 > 32
])
def test_kernel_refuses_geometry(n, c, nh, hid):
    assert not sb.f32_kernel_supports(n, c, nh, hid)


@pytest.mark.parametrize("c", [180, 192])
def test_kernel_takes_w96_and_swinir_std_widths(c):
    assert sb.f32_kernel_supports(N, c, NH, 2 * c)


@pytest.mark.parametrize("n,c,nh,hid", [
    (49, 60, 6, 120), (64, 198, 6, 396), (64, 66, 2, 132)],
    ids=["window7", "c198", "head_dim33"])
def test_wrapper_refuses_geometry_on_cpu(n, c, nh, hid):
    """What the CUDA kernel does not take raises on the CPU too, so a
    CPU run refuses a geometry the card would refuse."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    args = [r(2, n, c), r(c, 3 * c), r(3 * c), r(c, c), r(c), r(c), r(c),
            r(c), r(c), r(c, hid), r(hid), r(hid, c), r(c), r(nh, n, n)]
    before = sb.fused_swin_block.launches
    with pytest.raises(ValueError, match="does not take"):
        sb.fused_swin_block(*args, num_heads=nh, windows_per_image=2)
    assert sb.fused_swin_block.launches == before


def test_non_cpu_non_cuda_tensor_raises():
    x, params, bias = _block_inputs(60, False, seed=4)
    args = [torch.from_numpy(a).to("meta") for a in (x, *params, bias)]
    with pytest.raises(ValueError, match="unsupported device"):
        sb.fused_swin_block(*args, num_heads=NH, windows_per_image=NW)


@pytest.mark.parametrize("stamp", [None, 0.0, 25.412, 39.99, 40.0, 227.0])
def test_softmax_auto_policy_matches_jax(stamp):
    assert sb.AUTO_CLAMP_MARGIN == jax_sb.AUTO_CLAMP_MARGIN
    assert sb.resolve_softmax_auto(stamp) == jax_sb.resolve_softmax_auto(stamp)


@pytest.mark.parametrize("raw,want", [
    ("", frozenset()), ("none", frozenset()), ("0", frozenset()),
    ("qkv", frozenset({"qkv"})), ("qkv, mlp", frozenset({"qkv", "mlp"})),
    ("all", frozenset({"qkv", "mlp", "proj", "conv"})),
])
def test_quant_flags_match_jax(monkeypatch, raw, want):
    monkeypatch.setenv("RDST_TPU_PALLAS_QUANT", raw)
    assert wa.quant_flags(raw) == jax_sb.quant_flags() == want


def test_quant_flags_unknown_group_raises():
    with pytest.raises(ValueError, match="bogus"):
        wa.quant_flags("qkv,bogus")
