"""The port's slice as a whole: ``rdst_tpu_torch.models.build_generator``
against ``rdst_tpu.models.build_generator`` on the CPU, f32, the JAX side
on its XLA path.

* a narrow RDST (2 RDSTBs, embed 12, growth 6, 3 heads, window 4) on
  seeded random weights carried across by ``checkpoint.convert``;
* the shipped RDST-E1 x4 config with the committed flagship weights on
  one 16x24 LR slice.

Both the port's plain path and its kernel path (the kernel wrapper's CPU
version) are held to 1e-4 max abs: 48 f32 blocks in a row, each exact
to summation order.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.kernels import swin_block
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import _lcm_all, pad_to_window_multiple
from rdst_tpu_torch.nn.swin import set_block_kernels

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini")
SNAPSHOT = REPO / "weights" / "rdst_e1_40k_best_oasis20_x4.msgpack"
TOL = 1e-4

SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [3, 3], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [3, 3]}


def _paras(cls, overrides):
    p = cls(CONFIG)
    for k, v in overrides.items():
        p.set(k, v)
    return p


def _random_tree(tree, seed):
    """Seeded normal leaves (LayerNorm scales around 1, kernels at
    1/sqrt(fan_in)) with the structure of a flax param tree."""
    rng = np.random.default_rng(seed)
    flat = mr.flatten(jax.tree_util.tree_map(np.asarray, tree))
    out = {}
    for path, v in flat.items():
        shape = np.shape(v)
        if path[-1] == "scale":
            val = 1.0 + rng.normal(0, 0.1, shape)
        elif path[-1] == "kernel":
            val = rng.normal(0, int(np.prod(shape[:-1])) ** -0.5, shape)
        else:
            val = rng.normal(0, 0.1, shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val.astype(np.float32)
    return out


def _port_model(paras, params):
    model = build_generator(paras)
    sd = export_rdstsr(params, model.mean, model.std)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model.eval()


def _run_port(model, x, mode):
    set_block_kernels(model, mode != "off")
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("mode", ["off", "rdstb"], ids=["plain", "kernel"])
@pytest.mark.parametrize("hw", [(12, 16), (10, 14)], ids=["aligned", "padded"])
def test_small_rdst_matches_jax(monkeypatch, mode, hw):
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    jp = _paras(JaxParams, SMALL)
    jm = jax_build(jp)
    x = np.random.default_rng(7).random((2,) + hw + (1,), dtype=np.float32)
    init = jax.jit(lambda k, x: jm.init(k, x))(jax.random.PRNGKey(0), x)
    params = _random_tree(init, 11)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(params, x))

    model = _port_model(_paras(ParametersLoader, SMALL), params)
    before = swin_block.fused_swin_block.launches
    got = _run_port(model, x, mode)
    assert swin_block.fused_swin_block.launches == before  # CPU: no launch
    assert got.shape == want.shape == (2, 4 * hw[0], 4 * hw[1], 1)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("mode", ["off", "rdstb"], ids=["plain", "kernel"])
def test_flagship_full_width_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    data = SNAPSHOT.read_bytes()
    jm = jax_build(JaxParams(CONFIG))
    x = np.random.default_rng(3).random((1, 16, 24, 1), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, 4.0))(
        serialization.msgpack_restore(data), x))

    model = _port_model(ParametersLoader(CONFIG), mr.msgpack_restore(data))
    got = _run_port(model, x, mode)
    assert got.shape == want.shape == (1, 64, 96, 1)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL


def test_kernel_path_routes_every_swin_block(monkeypatch):
    """48 Swin blocks per forward at the flagship geometry, all through
    the kernel wrapper (``run_f32_block``, with the plan each block keeps)
    when the model was built in a kernel mode, none when it was built
    with the kernels off. The mode is the model's own: the env flag, read
    when the model is built, no longer matters after."""
    calls = []
    real = swin_block.run_f32_block

    def spy(x, plan, **kw):
        calls.append((x.shape[-1], plan.bias.shape[0]))
        return real(x, plan, **kw)

    monkeypatch.setattr(swin_block, "run_f32_block", spy)
    monkeypatch.setenv("RDST_TORCH_KERNELS", "off")
    x = torch.zeros(1, 40, 32, 1)
    for mode, n in (("rdstb", 48), ("pack", 48), ("off", 0), (None, 0)):
        p = ParametersLoader(CONFIG)
        if mode is not None:
            p.set("pallas_kernels", mode)
        model = build_generator(p).eval()
        assert model.kernel_mode == ("" if mode in ("off", None) else mode)
        monkeypatch.setenv("RDST_TORCH_KERNELS", "swin")
        calls.clear()
        with torch.inference_mode():
            model(x)
        assert len(calls) == n, mode
        monkeypatch.setenv("RDST_TORCH_KERNELS", "off")
    model = build_generator(ParametersLoader(CONFIG)).eval()
    set_block_kernels(model, True)
    calls.clear()
    with torch.inference_mode():
        model(x)
    # C in {60, 90, 120}; shared (6, N, N) bias or per-window (6*20, N, N)
    assert sorted(set(calls)) == [(c, b) for c in (60, 90, 120)
                                  for b in (6, 120)]


def test_pad_to_window_multiple_reflects():
    x = torch.arange(2 * 5 * 6, dtype=torch.float32).reshape(1, 5, 6, 2)
    y, hw = pad_to_window_multiple(x, 4)
    assert hw == (5, 6) and y.shape == (1, 8, 8, 2)
    assert torch.equal(y[:, :5, :6], x)
    assert torch.equal(y[:, 5, :6], x[:, 3])  # reflect: edge not repeated
    assert torch.equal(y[:, :5, 6], x[:, :, 4])
    assert _lcm_all([6, 4]) == 12


@pytest.mark.parametrize("key,value,match", [
    ("feature_generator", "rcan", "Queue A 8 item 3"),
    ("meta_feature_generator", "RDN", "Queue A 8 item 3"),
    ("feature_generator", "ipt", "Queue A 8 item 3"),
    ("meta_feature_generator", "SRResNet-x", "LR feature extractor"),
    ("feature_generator", "dbpn", "Queue A 8 item 3"),
    ("feature_generator", "rdn-x", "unknown feature_generator"),
])
def test_unported_options_raise(key, value, match):
    """What the port refuses now that every generator builds: a generator
    or MetaSR extractor that neither package has. The ``.pt`` cases name
    ROADMAP Queue A 8 item 3, now closed: a reference torch snapshot of a
    convolutional family goes through its key mapper to the file (absent
    here), and MetaSR's is refused, the JAX package having no mapper for
    it either."""
    from rdst_tpu_torch.checkpoint.loading import load_well_trained_params

    p = ParametersLoader(CONFIG)
    p.set(key, value)
    if key == "meta_feature_generator":  # MetaSR with another extractor
        p.set("feature_generator", "metasr")
    if "Queue A 8" in match:
        exc, text = ((NotImplementedError, "JAX package has none either")
                     if key == "meta_feature_generator" else
                     (FileNotFoundError, "absent.pt"))
        with pytest.raises(exc, match=text):
            load_well_trained_params(torch.nn.Identity(), p, "absent.pt",
                                     [4.0])
    else:
        with pytest.raises(ValueError, match=match):
            build_generator(p)


def test_bf16_model_raises():
    """bfloat16 now builds (its kernels are ported); what the bf16
    kernels cannot take raises when the model is built, naming the mode
    to choose instead, and a dtype the port does not compute in raises."""
    model = build_generator(ParametersLoader(CONFIG), dtype=torch.bfloat16)
    assert model.dtype == torch.bfloat16
    assert model.routes == ["fused_rdstb"] * 8
    p = ParametersLoader(CONFIG)
    p.set("rdst_rdb_residual_scale", 0.5)
    with pytest.raises(ValueError, match="pallas_kernels='pair'"):
        build_generator(p, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float16"):
        build_generator(ParametersLoader(CONFIG), dtype=torch.float16)
