"""The Swin-based model zoo in the port against the JAX package on the
CPU: RDST-N (``rdst_global_bottleneck``, both bottlenecks), ESTSR (both
tails), the wavelet transformers (``wtb`` ... ``wts``, haar and db2),
Swin-MLP, and RDST's ``3conv`` / ``ape`` / ``remat`` options.

* each family's f32 forward from the same seeded params carried across by
  ``checkpoint.convert`` (plain path and the kernel path's CPU versions),
  within 1e-4 of the JAX forward, and the weights back to the flax tree
  bit for bit; WaveletSR at a DWT grid that keeps the shift and at one
  that drops it, through one port model; Swin-MLP shifted and unshifted;
* a bf16 RDST-N in mode rdstb and a bf16 WaveletSR in mode swin (the
  port's plain versions) against the JAX kernels in interpret mode
  (``RDST_TPU_PALLAS_INTERPRET=1``): 0.02 relative max;
* a snapshot that the port's trainer wrote (1 step, f32, CPU) loads in
  flax and the JAX forward on it equals the port's (1e-4);
* ``rdst_remat`` gradients equal those without it (1e-5), dropout
  included;
* the refusals: ``ape`` at another token count, a Swin-MLP input under
  its window, a bottleneck ratio that changes the width (the JAX
  package fails on the first three too), ``3conv`` in bf16 mode rdstb,
  WaveletSR in bf16 modes pair / rdstb, a ``.pt`` snapshot of these
  families (the JAX package has no key mapper for them); a ``.pt`` of a
  convolutional family loads.
"""

import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.models.swin_mlp import SwinMLPBlock as JaxSwinMLPBlock
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
from rdst_tpu_torch.checkpoint.convert import export_params
from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict
from rdst_tpu_torch.cli import train_main
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.swin_mlp import SwinMLPBlock
from rdst_tpu_torch.nn.layers import set_generator
from rdst_tpu_torch.nn.swin import set_block_kernels

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini")
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
TOL, BF16_TOL = 1e-4, 0.02
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [3, 3], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [1, 1],
         "patch_size": 8}
WT = {"feature_generator": "wtb", "wt_embed_dim": 16, "wt_depths": [2, 2],
      "wt_num_heads": [2, 2], "patch_size": 16}
MLP = {"feature_generator": "swinmlp", "swinmlp_embed_dim": 12,
       "swinmlp_depths": [2, 2], "swinmlp_num_heads": [2, 3],
       "swinmlp_window_size": 4, "patch_size": 16}
# name: (overrides, LR sizes (the JAX init at the first), scale)
CASES = {
    "rdstn-mlp": (dict(SMALL, rdst_global_bottleneck=True), [(16, 12)],
                  None),
    "rdstn-conv": (dict(SMALL, rdst_global_bottleneck=True,
                        rdst_global_bottleneck_mode="conv"), [(10, 14)],
                   None),
    "estsr-pixelshuffle": (dict(SMALL, feature_generator="estsr",
                                estsr_rrdb_depths=[2, 1]), [(16, 12)], None),
    "estsr-meta": (dict(SMALL, feature_generator="estsr", scale_free=True,
                        estsr_num_rrdb_blocks=1), [(12, 12)], 2.5),
    # DWT grids 24x16 (shift 4) and 8x8 (one window: no shift)
    "wavelet-haar": (WT, [(40, 32), (16, 12)], None),
    "wavelet-db2": (dict(WT, feature_generator="wts", wavelet_kernel="db2",
                         wt_depths=[2], wt_num_heads=[4]), [(20, 28)], None),
    "swinmlp-shifted": (MLP, [(16, 12)], None),
    # an 8x8 input at window 8: the JAX clamp drops the shift
    "swinmlp-unshifted": (dict(MLP, feature_generator="swin-mlp",
                               swinmlp_window_size=8), [(8, 8)], None),
    "rdst-3conv": (dict(SMALL, rdst_res_connection="3conv",
                        rdst_feature_last_operation=False), [(16, 12)], None),
    "rdst-3conv-feature-last": (dict(SMALL, rdst_res_connection="3conv"),
                                [(12, 16)], None),
    "rdst-ape": (dict(SMALL, rdst_ape=True), [(8, 8)], None),
}


def _seeded(jm, x, scale=None, seed=11):
    """Seeded params in the tree ``jm.init`` makes (traced, not run):
    LayerNorm scales around 1, kernels at 1 / sqrt(fan_in), the rest
    around 0, as ``test_torch_model._random_tree`` draws them."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, scale))
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in sorted(leaves, key=lambda kv: jax.tree_util.keystr(
            kv[0])):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            val = 1.0 + rng.normal(0, 0.1, shape)
        elif name == "kernel":
            val = rng.normal(0, int(np.prod(shape[:-1])) ** -0.5, shape)
        else:
            val = rng.normal(0, 0.1, shape)
        out.append((jax.tree_util.keystr(path), val.astype(np.float32)))
    vals = dict(out)
    return jax.tree_util.tree_unflatten(
        tree, [vals[jax.tree_util.keystr(p)] for p, _ in leaves])


def _paras(cls, overrides, config=CONFIG):
    p = cls(config)
    for k, v in overrides.items():
        p.set(k, v)
    return p


def _port(overrides, params, dtype=torch.float32):
    p = _paras(ParametersLoader, overrides)
    model = build_generator(p, dtype=dtype)
    sd = export_params(params, p.feature_generator,
                       getattr(model, "mean", (0.0,)),
                       getattr(model, "std", (1.0,)))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model.eval()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_family_f32_matches_jax(monkeypatch, name):
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    overrides, sizes, scale = CASES[name]
    jm = jax_build(_paras(JaxParams, overrides))
    xs = [np.random.default_rng(i).random((2,) + hw + (1,), dtype=np.float32)
          for i, hw in enumerate(sizes)]
    params = _seeded(jm, xs[0], scale)
    model = _port(overrides, params)
    assert model.routes == ([] if "swinmlp" in name else
                            ["fused_swin_block"] * len(model.routes))
    for x in xs:
        want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, scale))(
            params, x))
        for kernels in (False, True):  # plain; the kernels' CPU versions
            set_block_kernels(model, kernels)
            with torch.inference_mode():
                got = model(torch.from_numpy(x), scale).numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= TOL, (x.shape, kernels)
    back = mr.flatten(import_state_dict(model.state_dict())["params"])
    flat = mr.flatten(params["params"])
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


# name: (overrides, LR size, JAX kernel mode)
BF16_CASES = {
    "rdstn-rdstb": (dict(SMALL, rdst_global_bottleneck=True,
                         rdst_window_size=[8], rdst_num_heads=[3],
                         rdst_dense_layer_depths=[2], rdst_rdb_depths=[2],
                         patch_size=16), (16, 16), "rdstb"),
    "wavelet-swin": (dict(WT, wt_depths=[2]), (40, 32), "swin"),
}


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_plain_versions_match_jax_kernels(monkeypatch, name):
    overrides, hw, mode = BF16_CASES[name]
    x = np.random.default_rng(5).normal(0, 0.3, (1,) + hw + (1,)).astype(
        np.float32)
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    params = _seeded(jax_build(_paras(JaxParams, overrides)), x, seed=21)
    monkeypatch.setenv("RDST_TPU_PALLAS", mode)
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "stable")
    clear_kernel_caches()
    jm = jax_build(_paras(JaxParams, overrides), dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(
        params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    clear_kernel_caches()
    model = _port(dict(overrides, pallas_kernels=mode,
                       pallas_softmax="stable"), params, torch.bfloat16)
    assert model.kernel_mode == mode and len(set(model.routes)) == 1
    assert model.routes[0] == {"rdstb": "fused_rdstb",
                               "swin": "fused_swin_block"}[mode]
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= BF16_TOL


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "OASIS" / "example"
    synthetic.make_oasis_example(str(root), shape=(40, 48, 24))
    return root


TRAINED = {
    "estsr": dict(SMALL, feature_generator="estsr", estsr_rrdb_depths=[1],
                  estsr_num_rrdb_blocks=1),
    "wtp": dict(WT, feature_generator="wtp", wt_depths=[2],
                wt_num_heads=[2]),
    "swinmlp": dict(MLP, swinmlp_depths=[2], swinmlp_num_heads=[2]),
}


@pytest.mark.parametrize("name", list(TRAINED))
def test_trained_snapshot_loads_in_flax(monkeypatch, corpus, tmp_path, name):
    """One f32 training step of the port's entry point on the CPU; the
    snapshot it wrote restores into the JAX model's tree, and the JAX
    forward on it equals the port's trained model."""
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    over = {**TRAINED[name], "data_folder": str(corpus),
            "output_dir": str(tmp_path), "batch_size": 4,
            "epochs_in_total": {"WarmUP": 1}, "check_every": 1,
            "quick_eva_num_samples": 1, "multi_threads": 1,
            "training_dtype": "float32", "eva_metrics": "psnr ssim",
            "verbose": False}
    trainer = train_main(["--config-file", TINY, "--gpu-id", "-1"]
                         + [f"{k}={v!r}" for k, v in over.items()])
    snap = pathlib.Path(trainer.dirs["models"]) / "WarmUP_model_g.msgpack"
    jm = jax_build(_paras(JaxParams, over, TINY))
    patch = int(over["patch_size"])
    x0 = jnp.zeros((1, patch, patch, 1), jnp.float32)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0)
    restored = serialization.from_bytes(template, snap.read_bytes())
    x = np.random.default_rng(2).random((2, patch, patch, 1),
                                        dtype=np.float32)
    want = np.asarray(jax.jit(jm.apply)(restored, x))
    model = trainer.model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL


def test_remat_gradients_equal_without():
    """``rdst_remat`` recomputes each RDSTB in the backward: the loss and
    every gradient as without it, with dropout drawing the same masks."""
    grads = {}
    for remat in (False, True):
        p = _paras(ParametersLoader, dict(SMALL, rdst_remat=remat,
                                          swin_drop_rate=0.1))
        torch.manual_seed(0)
        model = build_generator(p).train()
        assert model.remat is remat
        set_generator(model, torch.Generator().manual_seed(3))
        x = torch.from_numpy(np.random.default_rng(4).random(
            (2, 8, 8, 1), dtype=np.float32))
        loss = model(x).square().mean()
        loss.backward()
        grads[remat] = (loss.item(), {n: q.grad.clone()
                                      for n, q in model.named_parameters()
                                      if q.grad is not None})
    (l0, g0), (l1, g1) = grads[False], grads[True]
    assert abs(l0 - l1) <= 1e-6 and g0.keys() == g1.keys()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-5)


def _raises_ape():
    p = _paras(ParametersLoader, dict(SMALL, rdst_ape=True))
    model = build_generator(p)  # the table of 8x8 = 64 tokens
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="64 positions.*96"):
        model(torch.zeros(1, 8, 12, 1))
    jm = jax_build(_paras(JaxParams, dict(SMALL, rdst_ape=True)))
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)))
    with pytest.raises(Exception):
        jax.eval_shape(jm.apply, v, jnp.zeros((1, 8, 12, 1)))


def _raises_swinmlp_under_window():
    blk = SwinMLPBlock(8, 2, window_size=8)
    with pytest.raises(ValueError, match="window 8 on a 4x8 input"):
        blk(torch.zeros(1, 32, 8), (4, 8))
    jb = JaxSwinMLPBlock(dim=8, num_heads=2, window_size=8)
    v = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 64, 8)), (8, 8)))
    with pytest.raises(Exception):
        jax.eval_shape(lambda: jb.apply(v, jnp.zeros((1, 32, 8)), (4, 8)))


def _raises_bottleneck_ratio():
    over = dict(SMALL, rdst_global_bottleneck=True,
                rdst_global_bottleneck_ratio=0.5)
    with pytest.raises(ValueError, match="ratio 0.5"):
        build_generator(_paras(ParametersLoader, over))
    jm = jax_build(_paras(JaxParams, over))
    with pytest.raises(Exception):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 8, 8, 1)))


def _raises_3conv_rdstb():
    p = _paras(ParametersLoader, {"rdst_res_connection": "3conv"})
    with pytest.raises(ValueError, match="pallas_kernels='pair'"):
        build_generator(p, dtype=torch.bfloat16)
    p.set("pallas_kernels", "pair")
    model = build_generator(p, dtype=torch.bfloat16)
    assert model.routes == ["fused_swin_pair"] * 8


def _raises_wavelet_pair_rdstb():
    for mode in ("rdstb", "pair"):
        p = _paras(ParametersLoader, dict(WT, pallas_kernels=mode))
        with pytest.raises(ValueError, match="pallas_kernels='swin'"):
            build_generator(p, dtype=torch.bfloat16)
    p = _paras(ParametersLoader, dict(WT, pallas_kernels="swin"))
    assert build_generator(p, dtype=torch.bfloat16).routes == \
        ["fused_swin_block"] * 2


def _raises_conv_family():
    """The convolutional families build, and since their key mappers are
    ported a reference torch ``.pt`` of one loads (here written by the
    port in the reference layout, read into a zeroed twin); an unknown
    generator raises."""
    from rdst_tpu_torch.checkpoint import torch_export, torch_import
    from rdst_tpu_torch.models.rcan import RCAN

    for name, over in (("rcan", {}), ("convnet-lite", {}),
                       ("zssr", {"zssr_num_layers": 3, "zssr_n_feats": 8})):
        p = _paras(ParametersLoader, dict(over, feature_generator=name))
        arch = torch_import.mapper_arch(name)
        make = ((lambda: RCAN(n_resgroups=1, n_resblocks=1, n_feats=8,
                              reduction=4).eval()) if name == "rcan"
                else (lambda: build_generator(p)))
        model, twin = make(), make()
        with torch.no_grad():
            for q in twin.parameters():
                q.zero_()
        with tempfile.TemporaryDirectory() as tmp:
            pt = str(pathlib.Path(tmp) / "ref.pt")
            torch_export.save_torch_checkpoint(
                model, pt, arch, *torch_export.mean_std(model),
                template=torch_export.reference_template(model, arch),
                **torch_import.mapper_kwargs(p, arch))
            load_well_trained_params(twin, p, pt, [4.0])
        for k, v in model.state_dict().items():
            assert torch.equal(twin.state_dict()[k], v), (name, k)
    with pytest.raises(ValueError, match="unknown feature_generator"):
        build_generator(_paras(ParametersLoader,
                               {"feature_generator": "nonesuch"}))


def _raises_pt_import():
    """No reference torch key mapper for these families, in either
    package: a ``.pt`` snapshot is refused before it is read."""
    for over in (dict(SMALL, rdst_global_bottleneck=True),
                 dict(SMALL, feature_generator="estsr"), WT, MLP):
        p = _paras(ParametersLoader, over)
        with pytest.raises(NotImplementedError, match="no reference torch"):
            load_well_trained_params(build_generator(p), p, "absent.pt",
                                     [4.0])


@pytest.mark.parametrize("check", [
    _raises_ape, _raises_swinmlp_under_window, _raises_bottleneck_ratio,
    _raises_3conv_rdstb, _raises_wavelet_pair_rdstb, _raises_conv_family,
    _raises_pt_import],
    ids=lambda f: f.__name__[len("_raises_"):])
def test_refusals(check):
    check()
