"""Five places where ``rdst_tpu`` served and the port failed (ROADMAP
Queue C 1-5), each held against the JAX package on the CPU, and one
kernel fault of the port (the last test):

1. the f32 kernel route on an image of one window (LR 5x5, 8x8): the
   shifted bias kept the permuted strides of the relative-position
   bias and the wrapper refused it;
2. the bf16 pair route on a padded one-window image: the pair wrapper
   was handed a non-contiguous window partition;
3. LR sides of 4 or less: torch's reflect pad refuses a pad >= the side,
   ``jnp.pad(mode='reflect')`` reflects again;
4. f32 routes are checked when the model is built, not at the first
   ``predict``, by the f32 kernel's own limits (W96 as shipped builds;
   a head dim over 32 raises);
5. ``pallas_quant`` in f32 is dropped, as the JAX precise path drops
   it; in bf16 'qkv' runs on the kernels and the groups not ported
   raise;
6. the persistent window kernel at one 32-column output piece (C <= 32)
   serialized its wgmma on the card: it is not built, and the plan sends
   those widths to the token-parallel forward (``window_kernel_supports``
   refuses them; asked for by name, the window route raises and names
   the route that takes them), whose plain version agrees with the JAX
   fast block;
7. the forwards made tensors from Python numbers on every call (the
   MeanShift / ``mean_shift`` normalization, LeakyReLU's slope, SwinIR's
   RGB mean, the reflect-padding index), a host-to-device copy that a
   CUDA graph cannot capture: they are build-time buffers (or tables made
   once a geometry) now, and give bitwise the numbers they gave before;
   every kernel launch of ``kernels/`` and ``csrc/`` runs on the current
   stream.
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
    assert build_generator(p).routes == ["fused_swin_block"] * 8
    # 3 heads: head dims 32 / 48 / 64, over the kernel's 32
    p.set("rdst_num_heads", [3] * 8)
    with pytest.raises(ValueError, match="pallas_kernels='off'") as e:
        build_generator(p)
    assert "RDSTB 0" in str(e.value) and "C=144, 3 heads" in str(e.value)
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
    model, meta = export.build_serving_model(
        _paras(pallas_quant="qkv", inference_dtype="bfloat16"),
        device="cpu")
    assert meta["pallas_quant"] == ["qkv"]
    assert meta["routes"] == ["fused_rdstb"] * 8
    model, meta = export.build_serving_model(
        _paras(pallas_quant="mlp", inference_dtype="bfloat16"),
        device="cpu")
    assert meta["pallas_quant"] == ["mlp"]
    assert meta["routes"] == ["fused_rdstb"] * 8
    # int8 'mlp' sends every DSTL's stages to the token-parallel forward
    from rdst_tpu_torch.kernels.rdstb_block import plan_rdstb

    unit = model.route_units()[0][1]
    assert unit.quant == frozenset({"mlp"})
    plan = plan_rdstb(*unit.rdstb_inputs((16, 16), 8, 4),
                      num_heads=unit.num_heads, growth=unit.growth_rate,
                      adapter_prenorm=unit.pre_norm, quant=unit.quant)
    assert plan.routes == ["tokens"] * 3 and plan.int8_mask == 2


@pytest.mark.parametrize("c,nh", [(16, 2), (24, 4), (32, 4), (36, 6),
                                  (60, 6)])
def test_window_kernel_refuses_one_output_piece(monkeypatch, c, nh):
    from test_torch_swin_block_fast import NW, block_inputs, jax_fast_block

    from rdst_tpu_torch.kernels import swin_block as sb
    from rdst_tpu_torch.kernels import window_body as wb

    narrow = wb.make_geom(64, c, nh, 2 * c).no < sb.WINDOW_MIN_NO
    assert narrow == (c <= 32)
    assert sb.window_kernel_supports(64, c, nh, 2 * c) == (not narrow)
    assert sb.window_kernel_supports(16, c, nh, 2 * c) == (not narrow)
    x, params, bias = block_inputs(c, nh, False)
    tp = [torch.from_numpy(a) for a in params]
    tb = torch.from_numpy(bias).bfloat16()
    plan = sb.plan_fast_block(tp, tb, num_heads=nh)
    assert plan.route == ("tokens" if narrow else "window")
    if narrow:
        with pytest.raises(ValueError, match="route 'tokens'"):
            sb.plan_fast_block(tp, tb, num_heads=nh, route="window")
        xb = torch.from_numpy(x).bfloat16()
        got = sb.run_fast_block(xb, plan, num_heads=nh, windows_per_image=NW,
                                softmax="clamp").float().numpy()
        want = np.asarray(jax_fast_block(monkeypatch, x, params, bias, nh,
                                         "clamp"), np.float32)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 0.02, err
    src = (REPO / "rdst_tpu_torch" / "csrc" / "swin_block_fast.cu").read_text()
    assert "launch_window<1>" not in src
    assert all(f"launch_window<{k}>" in src for k in (2, 3, 4))


# -- 7. capture safety --------------------------------------------------------

def _old_mean_shift(x, mean, std, mode):
    """``nn.common.mean_shift`` as it was: tensors made from the numbers
    on every call."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std if mode == "sub" else x * std + mean


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sub", "add"])
def test_mean_shift_from_buffers(dtype, mode):
    from rdst_tpu_torch.nn.common import MeanShift, mean_shift, norm_buffers

    rng = np.random.default_rng(21)
    for nc in (1, 3):
        mean = tuple(float(v) for v in rng.random(nc))
        std = tuple(float(v) for v in 0.1 + rng.random(nc))
        x = torch.from_numpy(rng.standard_normal((2, 5, 6, nc)).astype(
            np.float32)).to(dtype)
        holder = torch.nn.Module()
        norm_buffers(holder, mean, std)
        assert holder.mean == mean and holder.state_dict() == {}
        want = _old_mean_shift(x, mean, std, mode)
        got = mean_shift(x, holder.norm_mean, holder.norm_std, mode)
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
        if dtype == torch.bfloat16:  # MeanShift's bf16 path
            ms = MeanShift(mean, std, mode)
            assert set(ms.state_dict()) == {"weight", "bias"}
            assert torch.equal(ms(x), want)
    # the models keep their numbers as buffers, out of the state_dict
    model = build_generator(_paras(), (0.25,), (0.5,))
    assert model.sub_mean.norm_mean.tolist() == [0.25]
    assert not any("norm_" in k for k in model.state_dict())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaky_relu_slope_from_buffer(dtype):
    from rdst_tpu_torch.nn.layers import LeakyReLU

    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (4, 7, 9)).astype(np.float32)).to(dtype)
    for slope in (0.2, 0.01, 0.1234567):
        act = LeakyReLU(slope)
        old = torch.where(x >= 0, x,
                          x * torch.tensor(slope, dtype=x.dtype))
        assert torch.equal(act(x), old) and act.state_dict() == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swinir_rgb_mean_from_buffer(dtype):
    from rdst_tpu_torch.models.swinir import SwinIR

    for chans in (3, 1):
        model = SwinIR(in_chans=chans, embed_dim=12, depths=(2,),
                       num_heads=(2,), window_size=4, upscale=2,
                       upsampler="pixelshuffledirect", dtype=dtype)
        old = torch.tensor(model.rgb_mean, dtype=dtype)
        assert torch.equal(model.rgb_mean_value.to(dtype), old)
        assert "rgb_mean_value" not in model.state_dict()
        with torch.no_grad():  # subtracted and added back
            y = model.eval()(torch.zeros(1, 8, 8, chans))
        assert y.shape == (1, 16, 16, chans)


def test_reflect_index_made_once_a_geometry():
    from rdst_tpu_torch.models.rdst import _reflect_index_on, reflect_index

    dev = torch.device("cpu")
    a = _reflect_index_on(5, 13, dev)
    assert torch.equal(a, reflect_index(5, 13))
    assert _reflect_index_on(5, 13, dev) is a


def _launch_configs(src: str):
    """The ``<<<...>>>`` launch configurations of a CUDA source, each
    split at its top-level commas."""
    import re

    out = []
    for m in re.finditer(r"<<<(.*?)>>>", src, re.S):
        parts, depth, cur = [], 0, ""
        for ch in m.group(1):
            depth += ch in "([{"
            depth -= ch in ")]}"
            if ch == "," and depth == 0:
                parts.append(cur.strip())
                cur = ""
            else:
                cur += ch
        parts.append(cur.strip())
        out.append(parts)
    return out


def test_every_launch_runs_on_the_current_stream():
    """A CUDA graph captures the work of its capture stream: every launch
    of the port's kernels goes through ``kernels.swin_block.launch``, which
    passes the current stream of the tensors' device, and every kernel
    launch and memset in ``csrc/`` names the stream it was given."""
    import ast
    import inspect
    import re

    from rdst_tpu_torch.kernels import swin_block

    assert "torch.cuda.current_stream(device).cuda_stream" in \
        inspect.getsource(swin_block.launch)
    pkg = REPO / "rdst_tpu_torch"
    # entries that only size or count (no device work, no stream)
    query = re.compile(r"(_work_bytes|_work_floats|_kernels|_error_string)$")
    for path in sorted((pkg / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(
                    f.value, ast.Name) and f.value.id == "lib":
                assert query.search(f.attr), (path.name, f.attr)
            # an entry looked up by name: only launch / work_bytes do it
            if isinstance(f, ast.Name) and f.id == "getattr" and \
                    len(node.args) == 2 and path.name != "swin_block.py":
                assert not (isinstance(node.args[0], ast.Name)
                            and node.args[0].id == "lib"), path.name
    configs = 0
    for path in sorted((pkg / "csrc").glob("*.cu*")):
        src = path.read_text()
        for parts in _launch_configs(src):
            configs += 1
            assert len(parts) == 4 and parts[3], (path.name, parts)
        for call in re.findall(r"cudaMemsetAsync\((.*?)\);", src, re.S):
            assert call.count(",") == 3, (path.name, call)
        assert not re.search(r"cudaMemset\(|cudaMemcpy\(|"
                             r"cudaDeviceSynchronize|cudaStreamSynchronize|"
                             r"cudaMalloc\(", src), path.name
        for call in re.findall(r"cudaLaunchCooperativeKernel\((.*?)\);",
                               src, re.S):
            assert call.count(",") == 5, (path.name, call)
    assert configs >= 20
