"""The convolutional model zoo in the port against the JAX package on the
CPU, at small depth and width on non-square inputs: SRResNet, SRDenseNet,
RDN, ESRGAN, MDSR (at 2 / 3 / 4), RCAN, HAN, ConvNeXt-SR, ZSSR, DBPN (x2
and x4), IPT (two scales) and MetaSR on each of its six extractors (at 1.5
and 4).

* each family's f32 forward from the same seeded params carried across by
  ``checkpoint.convert``, within 1e-4 of max|y| of the JAX forward (RCAN in
  float64 on both sides within 1e-9: its hard 0/1 gate flips at near-ties
  under float32 rounding), and the weights back to the flax tree bit for
  bit; the per-scale branches of MDSR, Meta_MDSR and IPT are those of a
  flax init over every training scale, as the JAX trainer makes them;
* the L1 loss's parameter gradients against ``jax.grad`` for RCAN
  (float64; the gate carries no gradient), DBPN and HAN;
* bf16 forwards of HAN, DBPN and IPT against the JAX bf16 forwards: 0.02
  relative max;
* a snapshot that the port's trainer wrote (1 step, f32, CPU) loads in
  flax and the JAX forward on it equals the port's, for DBPN, HAN and IPT;
* a ``.pt`` snapshot of each family loads (MetaSR's is refused: the JAX
  package has no mapper for it); the refusals that hold: an unknown
  generator or extractor, MDSR at
  2.5, IPT at another size, ZSSR and IPT served without their keys;
* the new modules import with jax, flax, msgpack and rdst_tpu blocked.
"""

import pathlib
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.models.convnext_sr import ConvNetSR as JaxConvNetSR
from rdst_tpu.models.han import HAN as JaxHAN
from rdst_tpu.models.rcan import RCAN as JaxRCAN
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_named
from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict
from rdst_tpu_torch.cli import train_main
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models import han as port_han
from rdst_tpu_torch.models.convnext_sr import ConvNetSR
from rdst_tpu_torch.models.han import HAN
from rdst_tpu_torch.models.rcan import RCAN
from rdst_tpu_torch.serving.export import LiveModel

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini")
METASR = str(REPO / "config_files" / "metasr_20k_oasis20_x4.ini")
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
TOL, F64_TOL, BF16_TOL = 1e-4, 1e-9, 0.02
LR = (10, 8)
SR = {"srresnet_n_feats": 16, "srresnet_n_resblocks": 2}
SD = {"srdensenet_growth_rate": 4, "srdensenet_n_dense_layers": 2,
      "srdensenet_n_dense_blocks": 2, "srdensenet_n_feats": 12}
RD = {"rdn_n_feats": 12, "rdn_growth_rate": 6, "rdn_n_dense_layers": 2,
      "rdn_n_blocks": 2}
ES = {"esrgan_n_feats": 12, "esrgan_growth_rate": 6,
      "esrgan_n_dense_layers": 2, "esrgan_n_blocks": 2}
MD = {"mdsr_n_feats": 12, "mdsr_n_resblocks": 2}
ED = {"edsr_n_feats": 12, "edsr_n_resblocks": 2}
IPT = {"feature_generator": "ipt", "ipt_n_feats": 8, "ipt_num_heads": 2,
       "ipt_num_layers": 1, "patch_size": 12, "all_sr_scales": [2.0, 4.0]}
DBPN = {"feature_generator": "dbpn", "dbpn_n0": 12, "dbpn_nr": 6,
        "dbpn_t": 3}
# the hard-coded families, built from their classes: (JAX class, port
# class, kwargs)
SMALL_CLASSES = {
    "rcan": (JaxRCAN, RCAN, dict(n_resgroups=2, n_resblocks=2, n_feats=16,
                                 reduction=4)),
    "han": (JaxHAN, HAN, dict(n_resgroups=2, n_resblocks=2, n_feats=16,
                              reduction=4)),
    "convnext": (JaxConvNetSR, ConvNetSR, dict(n_feats=16, n_blocks=2)),
}
# name: (overrides of CONFIG or a SMALL_CLASSES key, LR sizes (the JAX
# init at the first), the scales each forward runs at, config)
CASES = {
    "srresnet": (dict(SR, feature_generator="srresnet"), [LR, (8, 12)],
                 [None], CONFIG),
    "srdensenet-all": (dict(SD, feature_generator="srdensenet"), [LR],
                       [None], CONFIG),
    "srdensenet-hl": (dict(SD, feature_generator="srdensenet",
                           srdensenet_type="hl"), [LR], [None], CONFIG),
    "srdensenet-h": (dict(SD, feature_generator="srdensenet",
                          srdensenet_type="h"), [LR], [None], CONFIG),
    "rdn": (dict(RD, feature_generator="rdn"), [LR], [None], CONFIG),
    "esrgan": (dict(ES, feature_generator="esrgan"), [LR], [None], CONFIG),
    "mdsr": (dict(MD, feature_generator="mdsr",
                  all_sr_scales=[2.0, 3.0, 4.0]), [LR], [2.0, 3.0, 4.0],
             CONFIG),
    "convnext": ("convnext", [LR, (9, 7)], [None], CONFIG),
    "han": ("han", [LR], [None], CONFIG),
    "rcan": ("rcan", [LR], [None], CONFIG),  # float64: its own test
    "zssr": ({"feature_generator": "zssr", "zssr_n_feats": 12,
              "zssr_num_layers": 4, "lr_image_size_remain": True},
             [(40, 32)], [None], CONFIG),
    "dbpn-x4": (DBPN, [LR, (6, 9)], [None], CONFIG),
    "dbpn-x2": (dict(DBPN, sr_scale=2.0), [LR], [None], CONFIG),
    "ipt": (IPT, [(12, 12)], [2.0, 4.0], CONFIG),
    **{f"metasr-{e.lower()}": (dict(SR, **SD, **RD, **ES, **MD, **ED,
                                    meta_feature_generator=e), [LR],
                               [1.5, 4.0], METASR)
       for e in ("EDSR", "SRResNet", "SRDenseNet", "RDN", "ESRGAN",
                 "Meta_MDSR")},
}


def _paras(cls, overrides, config=CONFIG):
    p = cls(config)
    for k, v in overrides.items():
        p.set(k, v)
    return p


def _train_scales(p) -> list:
    return [float(s) for s in p.all_sr_scales]


def _jax_model(name, dtype=jnp.float32):
    over, _, _, config = CASES[name]
    if isinstance(over, str):
        jcls, _, kw = SMALL_CLASSES[over]
        return jcls(**kw, dtype=dtype), [None]
    p = _paras(JaxParams, over, config)
    return jax_build(p, dtype=dtype), _train_scales(p)


def _port_model(name, dtype=torch.float32):
    over, _, _, config = CASES[name]
    if isinstance(over, str):
        _, pcls, kw = SMALL_CLASSES[over]
        return pcls(**kw, dtype=dtype).eval()
    return build_generator(_paras(ParametersLoader, over, config),
                           dtype=dtype)


def _seeded(jm, x, scales, seed=11, dtype=np.float32):
    """Seeded params in the tree a flax init over every training scale
    makes (traced, not run), as the JAX trainer's init touches them:
    kernels at 1 / sqrt(fan_in), LayerNorm scales around 1, the rest
    (biases, gammas, IPT's tables) around 0."""
    def init_all(mdl, x):
        out = None
        for s in scales:
            out = mdl(x, s)
        return out

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            method=init_all))
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    vals = {}
    for path, leaf in sorted(leaves, key=lambda kv: jax.tree_util.keystr(
            kv[0])):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            val = 1.0 + rng.normal(0, 0.1, shape)
        elif name == "kernel":
            val = rng.normal(0, int(np.prod(shape[:-1])) ** -0.5, shape)
        else:
            val = rng.normal(0, 0.1, shape)
        vals[jax.tree_util.keystr(path)] = val.astype(dtype)
    return jax.tree_util.tree_unflatten(
        tree, [vals[jax.tree_util.keystr(p)] for p, _ in leaves])


def _load(model, params):
    sd = export_named(params)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model


def _inputs(sizes, dtype=np.float32):
    return [np.random.default_rng(i).random((2,) + hw + (1,)).astype(dtype)
            for i, hw in enumerate(sizes)]


def _f64(model):
    """The port's module in float64 (tests only: no float64 mode on the
    main path)."""
    model.double()
    model.dtype = torch.float64
    return model


def _check_round_trip(model, params):
    back = mr.flatten(import_state_dict(model.state_dict())["params"])
    flat = mr.flatten(params["params"])
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))


@pytest.mark.parametrize("name", [n for n in CASES if n != "rcan"])
def test_family_f32_matches_jax(name):
    _, sizes, scales, _ = CASES[name]
    jm, train_scales = _jax_model(name)
    xs = _inputs(sizes)
    params = _seeded(jm, xs[0], train_scales)
    model = _load(_port_model(name), params)
    assert model.routes == [] and model.dtype == torch.float32
    fwd = jax.jit(lambda p, x, s: jm.apply(p, x, s), static_argnums=2)
    for x in xs:
        for s in scales:
            want = np.asarray(fwd(params, x, s))
            with torch.inference_mode():
                got = model(torch.from_numpy(x), s).numpy()
            assert got.shape == want.shape, (x.shape, s)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= TOL, (x.shape, s, err)
    _check_round_trip(model, params)


def _rcan_f64():
    jm, _ = _jax_model("rcan", jnp.float64)
    x = _inputs([LR], np.float64)[0]
    params = _seeded(jm, x, [None], dtype=np.float64)
    return jm, x, params, _load(_f64(_port_model("rcan")), params)


def test_rcan_float64_matches_jax():
    """RCAN is held in float64 on both sides: in float32 a gate at a
    near-tie of 0.5 may flip between the two packages' rounding, and the
    flip swaps a whole 3x3 conv output at that pixel."""
    with jax.enable_x64(True):
        jm, x, params, model = _rcan_f64()
        want = np.asarray(jax.jit(jm.apply)(params, x))
    assert want.dtype == np.float64
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64
    assert np.abs(got - want).max() / np.abs(want).max() <= F64_TOL
    # the float32 round trip of the weights
    model.float()
    model.dtype = torch.float32
    _check_round_trip(model, params)


def _grads_vs_jax(jm, params, model, x, scale, tol):
    target = np.random.default_rng(9).random(
        np.asarray(jax.eval_shape(lambda: jm.apply(params, x, scale)).shape)
    ).astype(x.dtype)

    def loss(p):
        return jnp.mean(jnp.abs(jm.apply(p, x, scale) - target))

    jg = export_named(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    model.train()
    out = model(torch.from_numpy(x), scale)
    torch.mean(torch.abs(out - torch.from_numpy(target))).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jg.keys()
    big = max(float(np.abs(v).max()) for v in jg.values())
    for n, g in jg.items():
        got = np.zeros_like(g) if grads[n] is None else grads[n].numpy()
        assert np.abs(got - g).max() <= tol * big, n


def test_rcan_gradients_match_jax_float64():
    with jax.enable_x64(True):
        jm, x, params, model = _rcan_f64()
        _grads_vs_jax(jm, params, model, x, None, F64_TOL)
        # the gate's 1x1 conv gets no gradient, as under stop_gradient
        assert model.body_0.rcab_0.conv_0.conv0.weight.grad is None


@pytest.mark.parametrize("name", ["dbpn-x4", "han"])
def test_gradients_match_jax(name):
    jm, scales = _jax_model(name)
    x = _inputs([LR])[0]
    params = _seeded(jm, x, scales)
    _grads_vs_jax(jm, params, _load(_port_model(name), params), x, None,
                  TOL)


@pytest.mark.parametrize("name", ["han", "dbpn-x4", "ipt"])
def test_bf16_matches_jax_bf16(name):
    _, sizes, scales, _ = CASES[name]
    jm32, train_scales = _jax_model(name)
    x = _inputs(sizes[:1])[0]
    params = _seeded(jm32, x, train_scales, seed=21)
    jm, _ = _jax_model(name, jnp.bfloat16)
    model = _load(_port_model(name, torch.bfloat16), params)
    for s in scales:
        want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, s))(
            params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
        with torch.inference_mode():
            got = model(torch.from_numpy(x), s)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert np.abs(got - want).max() / np.abs(want).max() <= BF16_TOL, s


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "OASIS" / "example"
    synthetic.make_oasis_example(str(root), shape=(40, 48, 24))
    return root


def _small_han(paras, mean=None, std=None, dtype=torch.float32):
    c = paras.input_channel
    return HAN(in_chans=c, sr_scale=int(paras.sr_scale),
               **SMALL_CLASSES["han"][2],
               mean=tuple(mean) if mean is not None else (0.0,) * c,
               std=tuple(std) if std is not None else (1.0,) * c,
               dtype=dtype, train_resolution=(paras.patch_size,) * 2).eval()


# TINY has no [IPT] section: E1's
IPT_KEYS = {"ipt_act": "relu", "ipt_patch_dim": 3, "ipt_num_queries": 3,
            "ipt_dropout_rate": 0, "ipt_no_norm": False, "ipt_no_mlp": False,
            "ipt_pos_every": False, "ipt_no_pos": False}
TRAINED = {"dbpn": DBPN, "han": {"feature_generator": "han"},
           "ipt": dict(IPT, **IPT_KEYS, all_sr_scales=[4.0])}


@pytest.mark.parametrize("name", list(TRAINED))
def test_trained_snapshot_loads_in_flax(monkeypatch, corpus, tmp_path, name):
    """One f32 training step of the port's entry point on the CPU (HAN at
    the small width through its factory); the snapshot it wrote restores
    into the JAX model's tree, and the JAX forward on it equals the port's
    trained model."""
    monkeypatch.setattr(port_han, "make_han", _small_han)
    config = TINY
    over = {**TRAINED[name], "data_folder": str(corpus),
            "output_dir": str(tmp_path), "batch_size": 4,
            "epochs_in_total": {"WarmUP": 1}, "check_every": 1,
            "quick_eva_num_samples": 1, "multi_threads": 1,
            "training_dtype": "float32", "eva_metrics": "psnr ssim",
            "tiled_inference": name == "ipt", "verbose": False}
    trainer = train_main(["--config-file", config, "--gpu-id", "-1"]
                         + [f"{k}={v!r}" for k, v in over.items()])
    snap = pathlib.Path(trainer.dirs["models"]) / "WarmUP_model_g.msgpack"
    if name == "han":
        jm = JaxHAN(**SMALL_CLASSES["han"][2])
    else:
        jm = jax_build(_paras(JaxParams, over, config))
    patch = int(_paras(JaxParams, over, config).patch_size)
    x0 = jnp.zeros((1, patch, patch, 1), jnp.float32)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x0,
                                              4.0))
    restored = serialization.from_bytes(template, snap.read_bytes())
    x = np.random.default_rng(2).random((2, patch, patch, 1),
                                        dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, 4.0))(restored, x))
    model = trainer.model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x), 4.0).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL


def test_builds_every_jax_generator():
    """Every name of the JAX registry builds (at small widths where a key
    sets them; RCAN, HAN and ConvNeXt-SR at their hard-coded ones), MetaSR
    on all six extractors."""
    from rdst_tpu.models.registry import BUILTIN_GENERATORS

    small = {**SR, **SD, **RD, **ES, **MD, **ED, "dbpn_n0": 8,
             "dbpn_nr": 4, "dbpn_t": 2, "ipt_num_layers": 1}
    built = {}
    for name in BUILTIN_GENERATORS:
        model = build_generator(_paras(ParametersLoader, dict(
            small, feature_generator=name)))
        built[name] = type(model).__name__
    assert built["convnet-lite"] == built["convnet-large"] == "ConvNetSR"
    for e in ("EDSR", "SRResNet", "SRDenseNet", "RDN", "ESRGAN",
              "Meta_MDSR"):
        model = build_generator(_paras(ParametersLoader, dict(
            small, meta_feature_generator=e), METASR))
        assert model.extractor_mode == e
        assert model.meta_upsampler.in_c == model.extractor.out_feats


PT_FAMILIES = ("srresnet", "srdensenet", "rdn", "esrgan", "mdsr", "rcan",
               "han", "convnet-large", "convnet-lite", "dbpn", "zssr", "ipt")


def _raises_pt_import():
    """Only MetaSR's reference torch ``.pt`` is refused (the JAX package has
    no mapper for it either); every other family's loads: a ``.pt`` that
    the port writes in the reference layout (``torch_export``) from one
    model fills a zeroed twin strictly, weight for weight."""
    from rdst_tpu_torch.checkpoint import torch_export, torch_import

    p = _paras(ParametersLoader, {"feature_generator": "metasr"}, METASR)
    with pytest.raises(NotImplementedError, match="JAX package has none"):
        load_well_trained_params(torch.nn.Identity(), p, "absent.pt", [4.0])
    for name in ("srresnet", "srdensenet-hl", "rdn", "esrgan", "mdsr",
                 "rcan", "han", "convnext", "zssr", "dbpn-x2", "ipt"):
        over = CASES[name][0]
        p = _paras(ParametersLoader, {} if isinstance(over, str) else over)
        if isinstance(over, str):
            p.set("feature_generator", {"convnext": "convnet-large"}.get(
                over, over))
        arch = torch_import.mapper_arch(p.feature_generator)
        model = _port_model(name)
        with tempfile.TemporaryDirectory() as tmp:
            pt = str(pathlib.Path(tmp) / "ref.pt")
            torch_export.save_torch_checkpoint(
                model, pt, arch, *torch_export.mean_std(model),
                template=torch_export.reference_template(model, arch),
                **torch_import.mapper_kwargs(p, arch))
            twin = _port_model(name)
            with torch.no_grad():
                for q in twin.parameters():
                    q.zero_()
            load_well_trained_params(twin, p, pt, [4.0])
        for k, v in model.state_dict().items():
            assert torch.equal(twin.state_dict()[k], v), (name, k)


def _raises_unknown_generator():
    with pytest.raises(ValueError, match="unknown feature_generator"):
        build_generator(_paras(ParametersLoader,
                               {"feature_generator": "vdsr"}))


def _raises_unknown_extractor():
    with pytest.raises(ValueError, match="LR feature extractor 'VDSR'"):
        build_generator(_paras(ParametersLoader,
                               {"meta_feature_generator": "VDSR"}, METASR))


def _raises_mdsr_fractional():
    """MDSR checks the scale before truncating it (int(2.5) would take
    branch 2); a scale it has no branch for raises too."""
    model = _port_model("mdsr")
    x = torch.zeros((1,) + LR + (1,))
    with torch.inference_mode():
        with pytest.raises(ValueError, match="Invalid sr_scale 2.5"):
            model(x, 2.5)
        with pytest.raises(ValueError, match="Invalid sr_scale None"):
            model(x)
    only4 = build_generator(_paras(ParametersLoader, dict(
        MD, feature_generator="mdsr")))
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match=r"\(4,\).*not 2"):
        only4(x, 2.0)
    jm, scales = _jax_model("mdsr")
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1,) + LR + (1,)), 2.0))
    with pytest.raises(ValueError, match="2.5"):
        jm.apply(v, jnp.zeros((1,) + LR + (1,)), 2.5)


def _raises_ipt_other_size():
    """IPT's tables hold the training patch's 16 tokens: a 12x15 input
    (20 tokens) raises naming both counts; the JAX apply fails on the
    shapes."""
    model = _port_model("ipt")
    with torch.inference_mode(), pytest.raises(
            ValueError, match="hold 16 tokens.*gives 20"):
        model(torch.zeros(1, 12, 15, 1), 2.0)
    jm, _ = _jax_model("ipt")
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 12, 12, 1)), 2.0))
    with pytest.raises(Exception):
        jax.eval_shape(lambda: jm.apply(v, jnp.zeros((1, 12, 15, 1)), 2.0))


def _raises_zssr_served_without_key():
    p = _paras(ParametersLoader, {"feature_generator": "zssr",
                                  "well_trained_single_scale_model_g":
                                      "absent.msgpack"})
    with pytest.raises(ValueError, match="lr_image_size_remain = True"):
        LiveModel(p, device="cpu")


def _raises_ipt_served_without_key():
    p = _paras(ParametersLoader, dict(
        IPT, well_trained_single_scale_model_g="absent.msgpack"))
    with pytest.raises(ValueError, match="tiled_inference = True"):
        LiveModel(p, device="cpu")


@pytest.mark.parametrize("check", [
    _raises_pt_import, _raises_unknown_generator, _raises_unknown_extractor,
    _raises_mdsr_fractional, _raises_ipt_other_size,
    _raises_zssr_served_without_key, _raises_ipt_served_without_key],
    ids=lambda f: f.__name__[len("_raises_"):])
def test_refusals(check):
    check()


def test_new_modules_import_without_jax():
    """The convolutional families build and run with jax, flax, msgpack
    and rdst_tpu blocked, as on the card's machine."""
    code = """
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "optax", "rdst_tpu"):
    sys.modules[name] = None
import torch
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict
for name, over in (("zssr", {"zssr_num_layers": 3}),
                   ("dbpn", {"dbpn_n0": 8, "dbpn_nr": 4, "dbpn_t": 2}),
                   ("mdsr", {"mdsr_n_resblocks": 1}),
                   ("ipt", {"ipt_num_layers": 1, "ipt_n_feats": 4,
                            "ipt_num_heads": 2})):
    p = ParametersLoader(%r)
    p.set("feature_generator", name)
    for k, v in over.items():
        p.set(k, v)
    m = build_generator(p)
    with torch.inference_mode():
        y = m(torch.zeros(1, 24, 24, 1), 4.0)
    import_state_dict(m.state_dict())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "flax", "msgpack", "rdst_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
""" % CONFIG
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
