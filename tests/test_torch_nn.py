"""Port of the nn pieces: ``rdst_tpu_torch.nn`` against ``rdst_tpu.nn``.

Each module gets the same seeded numpy parameters and inputs in both
packages (flax trees mapped to the port's state_dict the way
``checkpoint.convert`` maps them). Tolerance: 1e-5 max abs, f32 on the
CPU on both sides (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.nn import common as jc
from rdst_tpu.nn import layers as jl
from rdst_tpu.nn import swin as js
from rdst_tpu_torch.checkpoint.convert import _conv_w, _linear_w, _swin_leaf
from rdst_tpu_torch.checkpoint.msgpack_reader import flatten
from rdst_tpu_torch.nn import common as tc
from rdst_tpu_torch.nn import layers as tl
from rdst_tpu_torch.nn import swin as ts

TOL = 1e-5


def _randomize(tree, seed):
    """Same structure, every leaf seeded normal (LayerNorm scales 1 + noise,
    weights at 1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        shape = np.shape(v)
        if path[-1] == "scale":
            return (1.0 + rng.normal(0, 0.1, shape)).astype(np.float32)
        if path[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    flat = flatten(jax.tree_util.tree_map(np.asarray, tree))
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf(path, v)
    return out


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()})
    return module.eval()


def _swin_block_sd(params):
    """Flax SwinTransformerBlock params -> the port's state_dict."""
    sd = {}
    for path, v in flatten(params["params"]).items():
        key, val = _swin_leaf("/" + "/".join(path), v)
        sd[key.lstrip(".")] = val
    return sd


def test_window_partition_and_reverse_match_jax(rng):
    x = rng.normal(size=(2, 16, 24, 5)).astype(np.float32)
    want = np.asarray(js.window_partition(jnp.asarray(x), 8))
    got = ts.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    back = ts.window_reverse(got, 8, 16, 24).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(js.window_reverse(jnp.asarray(want), 8, 16, 24)))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("ws", [4, 7, 8])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(ts.relative_position_index(ws, ws),
                                  js.relative_position_index(ws, ws))


@pytest.mark.parametrize("h,w,ws,shift", [
    (40, 32, 8, 4), (16, 24, 8, 4), (12, 16, 4, 2), (40, 32, 8, 0)])
def test_shift_attention_mask_matches_jax(h, w, ws, shift):
    got = ts.shift_attention_mask(h, w, ws, shift)
    want = js.shift_attention_mask(h, w, ws, shift)
    if shift == 0:
        assert got is None and want is None
    else:
        assert set(np.unique(got)) <= {0.0, -100.0}
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decide,h,w,ws,shift", [
    ((24, 24), 40, 32, 8, 4), ((24, 24), 16, 24, 8, 4),
    ((6, 6), 40, 32, 8, 4), ((24, 24), 4, 32, 8, 4),
    ((24, 24), 6, 6, 8, 4), ((8, 8), 40, 32, 8, 4)])
def test_resolve_ws_shift_matches_jax(decide, h, w, ws, shift):
    assert (ts.resolve_ws_shift(decide, h, w, ws, shift)
            == js.resolve_ws_shift(decide, h, w, ws, shift))


def test_layernorm_and_mlp_match_flax(rng):
    x = rng.normal(size=(3, 10, 12)).astype(np.float32)
    ln = jl.LayerNorm()
    p = _randomize(ln.init(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(ln.apply(p, x))
    mod = _load(tl.LayerNorm(12), {"weight": p["params"]["scale"],
                                   "bias": p["params"]["bias"]})
    with torch.no_grad():
        assert np.abs(mod(torch.from_numpy(x)).numpy() - want).max() <= TOL

    mlp = jl.Mlp(hidden_features=24)
    p = _randomize(mlp.init(jax.random.PRNGKey(0), x), 2)["params"]
    want = np.asarray(mlp.apply({"params": p}, x))
    mod = _load(tl.Mlp(12, 24), {
        "fc1.weight": _linear_w(p["fc1"]["kernel"]), "fc1.bias": p["fc1"]["bias"],
        "fc2.weight": _linear_w(p["fc2"]["kernel"]), "fc2.bias": p["fc2"]["bias"]})
    with torch.no_grad():
        assert np.abs(mod(torch.from_numpy(x)).numpy() - want).max() <= TOL


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(tl.gelu_exact(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu_exact(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("cin,cout,k", [(1, 12, 3), (12, 12, 3), (30, 12, 1)])
def test_conv_matches_flax(rng, cin, cout, k):
    x = rng.normal(size=(2, 9, 7, cin)).astype(np.float32)
    conv = jc.Conv(cout, k)
    p = _randomize(conv.init(jax.random.PRNGKey(0), x), 3)
    want = np.asarray(conv.apply(p, x))
    pc = p["params"]["conv"]
    mod = _load(tc.Conv(cin, cout, k), {"weight": _conv_w(pc["kernel"]),
                                        "bias": pc["bias"]})
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax_and_torch(rng, r):
    x = rng.normal(size=(2, 5, 4, 3 * r * r)).astype(np.float32)
    got = tc.pixel_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.pixel_shuffle(jnp.asarray(x), r)))
    # torch.nn.PixelShuffle's channel order, on NCHW
    ref = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upsampler_matches_flax(rng, scale):
    x = rng.normal(size=(1, 5, 6, 8)).astype(np.float32)
    up = jc.UpSampler(scale, 8)
    p = _randomize(up.init(jax.random.PRNGKey(0), x), 4)
    want = np.asarray(up.apply(p, x))
    sd = {}
    for name, sub in p["params"].items():  # conv_i -> Sequential index 2i
        i = 2 * int(name.split("_")[1])
        sd[f"{i}.weight"] = _conv_w(sub["conv"]["kernel"])
        sd[f"{i}.bias"] = sub["conv"]["bias"]
    mod = _load(tc.UpSampler(scale, 8), sd)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 5 * scale, 6 * scale, 8)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("mode", ["sub", "add"])
def test_mean_shift_matches_jax(rng, mode):
    x = rng.normal(size=(2, 4, 5, 1)).astype(np.float32)
    mean, std = (0.3,), (1.7,)
    want = np.asarray(jc.mean_shift(jnp.asarray(x), mean, std, mode))
    got_fn = tc.mean_shift(torch.from_numpy(x),
                           torch.tensor(mean, dtype=torch.float64),
                           torch.tensor(std, dtype=torch.float64),
                           mode).numpy()
    with torch.no_grad():
        got_mod = tc.MeanShift(mean, std, mode)(torch.from_numpy(x)).numpy()
    assert np.abs(got_fn - want).max() <= TOL
    assert np.abs(got_mod - want).max() <= TOL


@pytest.mark.parametrize("kernel_mode", ["0", "swin"], ids=["plain", "kernel"])
@pytest.mark.parametrize("shift", [0, 4], ids=["unshifted", "shifted"])
def test_swin_block_matches_flax(rng, monkeypatch, shift, kernel_mode):
    """The plain path and the kernel path (the wrapper's CPU version) of
    the port's block, against the flax block on its XLA path."""
    b, h, w, c, nh, ws = 2, 16, 24, 12, 3, 8
    x = rng.normal(size=(b, h * w, c)).astype(np.float32)
    blk = js.SwinTransformerBlock(dim=c, num_heads=nh, window_size=ws,
                                  shift_size=shift, mlp_ratio=2.0,
                                  build_resolution=(24, 24))
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    p = _randomize(blk.init(jax.random.PRNGKey(0), x, (h, w)), 5)
    want = np.asarray(blk.apply(p, x, (h, w)))

    mod = _load(ts.SwinTransformerBlock(c, nh, ws, shift, 2.0,
                                        build_resolution=(24, 24)),
                _swin_block_sd(p))
    assert ts.set_block_kernels(mod, kernel_mode == "swin") == 1
    assert mod.use_kernel == (kernel_mode == "swin")
    with torch.no_grad():
        got = mod(torch.from_numpy(x), (h, w)).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("kw,c,nh", [
    ({}, 198, 6),                     # C = 198 > 192, the kernel's widest
    ({}, 240, 6),                     # head dim 40 > 32
    ({"layer_norm": False}, 12, 3),   # the kernel always normalizes
    ({"qk_scale": 0.5}, 12, 3),       # the kernel scales by hd^-0.5
], ids=["c198", "head_dim40", "no_layer_norm", "qk_scale"])
def test_kernel_mode_refuses_what_the_kernel_does_not_take(kw, c, nh):
    """In kernel mode a block the kernel does not take raises instead of
    taking the plain path; off, the same block runs."""
    blk = ts.SwinTransformerBlock(c, nh, 8, 4, 2.0, build_resolution=(16, 16),
                                  **kw).eval()
    x = torch.randn(1, 16 * 16, c, generator=torch.Generator().manual_seed(0))
    ts.set_block_kernels(blk, True)
    with torch.no_grad(), pytest.raises(ValueError, match="does not take|"
                                        "kernel takes"):
        blk(x, (16, 16))
    ts.set_block_kernels(blk, False)
    with torch.no_grad():
        assert torch.isfinite(blk(x, (16, 16))).all()


def test_kernel_inputs_bias_layout(monkeypatch):
    """Shifted: (nH*nW, N, N) head-major rel-pos + mask; unshifted: the
    shared (nH, N, N) rel-pos, as ``_kernel_inputs`` builds them."""
    blk = ts.SwinTransformerBlock(12, 3, 8, 4, 2.0, build_resolution=(24, 24))
    torch.nn.init.normal_(blk.attn.relative_position_bias_table)
    rel = blk.attn.rel_bias()
    _, bias = blk.kernel_inputs((16, 24), 8, 4)
    mask = torch.from_numpy(ts.shift_attention_mask(16, 24, 8, 4))
    assert bias.shape == (3 * 6, 64, 64)
    assert torch.equal(bias.reshape(3, 6, 64, 64), rel[:, None] + mask[None])
    _, bias0 = blk.kernel_inputs((16, 24), 8, 0)
    assert bias0.shape == (3, 64, 64) and torch.equal(bias0, rel)


def test_basic_layer_alternates_shift():
    layer = ts.BasicLayer(12, 4, 3, 8, 2.0, build_resolution=(24, 24))
    assert [b.shift_size for b in layer.blocks] == [0, 4, 0, 4]


def test_runtime_window_must_match_table():
    blk = ts.SwinTransformerBlock(12, 3, 8, 4, 2.0)  # built for window 8
    with pytest.raises(ValueError, match="window"):
        blk(torch.zeros(1, 4 * 32, 12), (4, 32))
