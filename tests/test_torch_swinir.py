"""The SwinIR slice as a whole: ``rdst_tpu_torch.models.swinir`` against
``rdst_tpu.models.swinir`` on the CPU.

* SwinIR-std and SwinIR-light x4 at full width with their committed
  weights, float32: the port's plain modules (and, for light, the f32
  block kernel's CPU version) against the JAX XLA forward, <= 1e-4 max
  abs (the port's f32 bar);
* the weight carry-over, key for key and value for value, both ways
  (flax tree -> state_dict as ``torch_export.export_swinir`` maps it;
  state_dict -> flax-readable msgpack bytes);
* a narrow SwinIR (C = 24, 2 heads, depths [2, 2]) in bf16, mode 'swin'
  with int8 qkv: the port (every kernel wrapper's plain version) against
  the JAX model with its kernels in interpret mode, at the shipped build
  resolution (every block unshifted) and at one that shifts the odd
  blocks: <= 0.02 relative max;
* the routes at build: SwinIR-std trains 36 blocks on the single-block
  train kernel, RDST-E1 24 pairs on the train pair, 'block' accepted;
  the block route and the plain bf16 route give the same step (the same
  stochastic-depth draws);
* the build-resolution quirk: every SwinIR-std block runs unshifted, as
  in ``rdst_tpu``;
* the port serves and trains SwinIR with jax, flax, msgpack and
  ``rdst_tpu`` unimportable.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.checkpoint.torch_export import export_swinir as jax_export
from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.models.swinir import SwinIR as JaxSwinIR
from rdst_tpu.nn.swin import resolve_ws_shift as jax_resolve
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_swinir
from rdst_tpu_torch.checkpoint.msgpack_writer import (import_state_dict,
                                                      to_bytes)
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import swin_block
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.routes import set_kernel_mode, set_train_mode
from rdst_tpu_torch.models.swinir import SwinIR
from rdst_tpu_torch.nn.layers import set_generator
from test_torch_model import _random_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
STD = "swinir_std_40k"
LIGHT = "swinir_light_40k"
TOL, BF16_TOL = 1e-4, 0.02


def _config(name):
    return str(REPO / "config_files" / f"{name}_oasis20_x4.ini")


def _snapshot(name):
    return REPO / "weights" / f"{name}_best_oasis20_x4.msgpack"


def _port(name, **over):
    p = ParametersLoader(_config(name))
    for k, v in over.items():
        p.set(k, v)
    return p


def _load(model, tree):
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in export_swinir(tree).items()})
    return model.eval()


@pytest.mark.parametrize("name,modes", [(STD, ("off",)),
                                        (LIGHT, ("off", "swin"))],
                         ids=["std", "light"])
def test_full_width_matches_jax(monkeypatch, name, modes):
    """f32, committed weights, one 16x24 LR slice (padded to 16x24 by
    window 8: 6 windows)."""
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    data = _snapshot(name).read_bytes()
    jm = jax_build(JaxParams(_config(name)))
    x = np.random.default_rng(3).random((1, 16, 24, 1), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(
        serialization.msgpack_restore(data), x))
    for mode in modes:
        model = _load(build_generator(_port(name, pallas_kernels=mode)),
                      mr.msgpack_restore(data))
        before = swin_block.fused_swin_block.launches
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        assert swin_block.fused_swin_block.launches == before  # CPU
        assert got.shape == want.shape == (1, 64, 96, 1)
        assert np.abs(got - want).max() <= TOL, mode


@pytest.mark.parametrize("name", [STD, LIGHT], ids=["std", "light"])
def test_weight_carry_over_key_for_key(name):
    """The port's state_dict keys are the ones ``torch_export
    .export_swinir`` writes, with equal values; the port's snapshot bytes
    restore with flax to the committed tree."""
    data = _snapshot(name).read_bytes()
    tree = serialization.msgpack_restore(data)
    want = jax_export(tree)
    got = export_swinir(mr.msgpack_restore(data))
    model = build_generator(_port(name, pallas_kernels="off"))
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _load(model, mr.msgpack_restore(data))
    back = serialization.msgpack_restore(to_bytes(import_state_dict(
        model.state_dict())))
    flat_back = mr.flatten(back)
    flat_tree = mr.flatten(tree)
    assert set(flat_back) == set(flat_tree)
    for k, v in flat_tree.items():
        np.testing.assert_array_equal(flat_back[k], np.asarray(v),
                                      err_msg="/".join(k))


NARROW = dict(in_chans=1, embed_dim=24, depths=(2, 2), num_heads=(2, 2),
              window_size=8, mlp_ratio=2.0, upscale=2,
              upsampler="pixelshuffle", num_feat=16)


@pytest.mark.parametrize("resi,upsampler,scale", [
    ("3conv", "pixelshuffledirect", 2), ("1conv", "pixelshuffle", 3)])
def test_narrow_f32_variants_match_jax(monkeypatch, resi, upsampler, scale):
    """The residual connection and upsampler variants the shipped configs
    do not cover ('3conv', the x3 pixel shuffle), f32 on seeded weights,
    on one 12x20 LR slice (padded to 16x24): <= 1e-4 max abs."""
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    kw = dict(NARROW, resi_connection=resi, upsampler=upsampler,
              upscale=scale, build_resolution=(16, 16))
    x = np.random.default_rng(6).random((1, 12, 20, 1), dtype=np.float32)
    jm = JaxSwinIR(**kw)
    init = jax.jit(lambda k, x: jm.init(k, x))(jax.random.PRNGKey(0), x)
    params = _random_tree(init, 41)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(params, x))
    model = _load(SwinIR(**kw), params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 12 * scale, 20 * scale, 1)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("build", [(8, 8), (16, 16)],
                         ids=["unshifted", "shifted"])
def test_narrow_bf16_matches_jax_interpret(monkeypatch, build):
    """bf16, mode 'swin', int8 qkv, softmax 'clamp': the JAX model with
    ``fused_swin_block`` in interpret mode against the port's plain
    versions, on one 16x16 LR slice (4 windows)."""
    x = np.random.default_rng(5).normal(0.5, 0.3, (1, 16, 16, 1)).astype(
        np.float32)
    jm = JaxSwinIR(**NARROW, build_resolution=build, dtype=jnp.bfloat16)
    init = jax.jit(lambda k, x: jm.init(k, x))(jax.random.PRNGKey(0), x)
    params = _random_tree(init, 31)
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS", "swin")
    monkeypatch.setenv("RDST_TPU_PALLAS_QUANT", "qkv")
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "clamp")
    clear_kernel_caches()
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(
        params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    clear_kernel_caches()

    model = _load(SwinIR(**NARROW, build_resolution=build,
                         dtype=torch.bfloat16), params)
    assert set_kernel_mode(model, "swin", "clamp", {"qkv"}) == \
        ["fused_swin_block"] * 2
    shifts = [b.resolved_window((16, 16))[1] for layer in model.layers
              for b in layer.residual_group.blocks]
    assert shifts == ([0, 0, 0, 0] if build == (8, 8) else [0, 4, 0, 4])
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (1, 32, 32, 1)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_build_resolution_quirk():
    """``make_swinir`` builds at (24 // 4 // 8 + 1) * 8 = 8, one window:
    every block, odd ones included, runs unshifted at the serving and the
    training sizes, as the JAX model's build resolution decides."""
    jm = jax_build(JaxParams(_config(STD)))
    model = build_generator(_port(STD), dtype=torch.bfloat16)
    assert tuple(model.layers[0].residual_group.build_resolution) == \
        tuple(jm.build_resolution) == (8, 8)
    blocks = [b for layer in model.layers
              for b in layer.residual_group.blocks]
    assert len(blocks) == 36
    assert [b.shift_size for b in blocks[:2]] == [0, 4]
    for size in ((40, 32), (24, 24)):
        for b in blocks:
            assert b.resolved_window(size) == jax_resolve(
                jm.build_resolution, *size, 8, b.shift_size) == (8, 0)


def test_routes_at_build():
    """Training routes by the JAX package's rules: SwinIR-std's blocks
    (C = 180) on the single-block kernel, RDST-E1's pairs (C <= 120) on
    the pair kernel, SwinIR-light's pairs (C = 60) on the pair kernel;
    'block' puts every block on the single-block kernel. Serving:
    SwinIR-std in mode 'swin' with int8 qkv, and with {'qkv', 'mlp'} and
    every group; the pair modes raise and name 'swin'."""
    std = build_generator(_port(STD), dtype=torch.bfloat16)
    assert std.routes == ["fused_swin_block"] * 6
    assert std.quant == frozenset({"qkv"}) and std.softmax == "stable_bc"
    assert set_train_mode(std, "pair") == "pair"
    assert std.train_routes == {"pair": 0, "block": 36}
    e1 = build_generator(ParametersLoader(
        str(REPO / "config_files" / "rdst_e1_100k_oasis20_x4.ini")),
        dtype=torch.bfloat16)
    set_train_mode(e1, "pair")
    assert e1.train_routes == {"pair": 24, "block": 0}
    assert set_train_mode(e1, "block") == "block"
    assert e1.train_routes == {"pair": 0, "block": 48}
    light = build_generator(_port(LIGHT, pallas_kernels="swin"),
                            dtype=torch.bfloat16)
    set_train_mode(light, "pair")
    assert light.train_routes == {"pair": 12, "block": 0}
    for mode in ("pair", "rdstb"):
        with pytest.raises(ValueError, match="pallas_kernels='swin'"):
            set_kernel_mode(std, mode, "clamp")
    for groups in ({"qkv", "mlp"}, frozenset(("qkv", "mlp", "proj",
                                              "conv"))):
        assert set_kernel_mode(std, "swin", "clamp", groups) == \
            ["fused_swin_block"] * 6
        assert std.quant == frozenset(groups)


def test_block_route_matches_plain_route():
    """One bf16 training step of a one-RSTB SwinIR at C = 180 (the width
    the pair kernel cannot hold): the single-block route's plain versions
    against the plain bf16 modules, from the same generator state, so
    both draw the same stochastic-depth factors (rate 0.5 here): loss and
    gradients within the bf16 bars of the training step (2e-2, 0.08)."""
    p = _port("swinir_std_100k", sir_swintr_layers=[2],
              sir_drop_path_rate=0.5)
    model = build_generator(p, dtype=torch.bfloat16)
    set_train_mode(model, "pair")
    assert model.train_routes == {"pair": 0, "block": 2}
    gen = torch.Generator().manual_seed(0)
    set_generator(model, gen)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (2, 24, 24, 1), dtype=np.float32))
    params = [q for q in model.parameters() if q.requires_grad]

    def step():
        model.train()
        loss = (model(x).float() - 0.5).abs().mean()
        return float(loss.detach()), torch.autograd.grad(loss, params)

    state = gen.get_state()
    loss_k, g_k = step()
    set_train_mode(model, "")
    gen.set_state(state)
    loss_p, g_p = step()
    gmax = max(float(g.abs().max()) for g in g_p)
    rel = max(float((a - b).abs().max())
              / max(1e-5, float(b.abs().max()), 0.12 * gmax)
              for a, b in zip(g_k, g_p))
    assert abs(loss_k - loss_p) <= 2e-2 * abs(loss_p)
    assert rel < 0.08


BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "cv2",
           "tabulate", "rdst_tpu")


def test_serves_and_trains_without_jax(tmp_path):
    """A card's host has none of jax, flax, msgpack or ``rdst_tpu``: the
    port serves SwinIR-std (bf16, int8 qkv, committed weights) and trains
    a narrow SwinIR-std (the block route) with all of them
    unimportable."""
    script = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from rdst_tpu_torch.cli import train_main
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.serving.export import LiveModel
p = ParametersLoader({_config(STD)!r})
p.set("well_trained_single_scale_model_g", {str(_snapshot(STD))!r})
live = LiveModel(p, max_batch=1, device="cpu")
y = live.predict(np.random.default_rng(0).random((1, 16, 8), dtype=np.float32), 4.0)
assert live.manifest["pallas_quant"] == ["qkv"], live.manifest
assert y.shape == (1, 64, 32, 1) and np.isfinite(y).all(), y.shape
root = {str(tmp_path / "OASIS")!r}
synthetic.make_oasis_example(root, shape=(40, 48, 4), patient_ids=tuple(
    f"OAS1_{{i:04d}}_MR1" for i in range(1, 21)))
over = dict(data_folder=root, output_dir={str(tmp_path / "out")!r},
            batch_size=2, epochs_in_total={{"WarmUP": 2}}, check_every=2,
            quick_eva_num_samples=1, multi_threads=1, margin_oasis=[4, 4],
            eva_metrics="psnr", verbose=False, sir_swintr_layers=[2])
tr = train_main(["--config-file", {_config("swinir_std_100k")!r},
                 "--gpu-id", "-1"] + [f"{{k}}={{v!r}}" for k, v in over.items()])
assert tr.model.train_routes == {{"pair": 0, "block": 2}}, tr.model.train_routes
assert len(tr.training_loss_records["WarmUP"]) == 2
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                {BLOCKED!r} and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
