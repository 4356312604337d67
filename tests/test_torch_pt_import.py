"""Reference torch checkpoints of every family that the JAX package maps
(``rdst_tpu/checkpoint/torch_import.py::_MAPPERS``) in the port, against
the JAX package on the CPU, at small widths:

* ``torch_export.reference_template`` of a built port model is read by the
  JAX ``convert_state_dict`` into a tree that passes the JAX
  ``verify_params_match`` against the JAX init: every flax leaf covered,
  none extra, none misshaped;
* a ``.pt`` that the JAX ``save_torch_checkpoint`` writes from seeded
  params loads into the port strictly (``load_well_trained_params``, and
  the trainer's ``pre_trained_g`` warm start), and its forward is
  ``torch.equal`` to the msgpack-loaded port model's;
* the port's ``export_from_template`` and ``convert_state_dict`` equal the
  JAX ones exactly; a ``.pt`` that the port writes from its module reads
  back, through the JAX mapper, into the same params;
* the errors: a BatchNorm ResBlock key and an unmapped key raise
  ``KeyError`` naming the family, PReLU slopes off 0.25 warn, the JAX
  trainer's aliases (``swin``, ``convnet-*``) load where the JAX tester
  raises ``KeyError``, and MetaSR's ``.pt`` is refused;
* the new modules run with jax, flax, msgpack and rdst_tpu blocked.
"""

import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import test_torch_zoo_conv as zc
from rdst_tpu.checkpoint import loading as jax_loading
from rdst_tpu.checkpoint import torch_export as jte
from rdst_tpu.checkpoint import torch_import as jti
from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu_torch.checkpoint import torch_export as pte
from rdst_tpu_torch.checkpoint import torch_import as pti
from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.runners.trainer import SRTrainer

SWINIR = str(zc.REPO / "config_files" / "swinir_std_40k_oasis20_x4.ini")
RDST = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
        "rdst_num_heads": [3, 3], "rdst_window_size": [4, 4],
        "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [1, 1],
        "patch_size": 8}
SIR = {"sir_embed_dim": 12, "sir_swintr_layers": [2],
       "sir_num_heads": [2], "sir_window_size": 4, "patch_size": 8}
# family: (feature_generator, zoo_conv CASES entry or (overrides, config),
# LR size, scale)
FAMILIES = {
    "rdst": ("rdst", (RDST, zc.CONFIG), (8, 12), None),
    "swinir": ("swinir", (SIR, SWINIR), (8, 12), None),
    "edsr": ("edsr", (dict(zc.ED, feature_generator="edsr"), zc.CONFIG),
             zc.LR, None),
    "srresnet": ("srresnet", "srresnet", zc.LR, None),
    "mdsr": ("mdsr", "mdsr", zc.LR, 3.0),
    "rdn": ("rdn", "rdn", zc.LR, None),
    "srdensenet": ("srdensenet", "srdensenet-hl", zc.LR, None),
    "esrgan": ("esrgan", "esrgan", zc.LR, None),
    "zssr": ("zssr", "zssr", (40, 32), None),
    "rcan": ("rcan", "rcan", zc.LR, None),
    "han": ("han", "han", zc.LR, None),
    "convnext": ("convnet-lite", "convnext", zc.LR, None),
    "dbpn": ("dbpn", "dbpn-x4", zc.LR, None),
    "ipt": ("ipt", "ipt", (12, 12), 2.0),
}


def _paras(cls, family):
    gen, case, _, _ = FAMILIES[family]
    if isinstance(case, str):
        over, _, _, config = zc.CASES[case]
        over = {} if isinstance(over, str) else over
    else:
        over, config = case
    p = cls(config)
    for k, v in dict(over, feature_generator=gen).items():
        p.set(k, v)
    return p


def _models(family):
    """(JAX model, its training scales, port model) at the small widths."""
    _, case, _, _ = FAMILIES[family]
    if isinstance(case, str):
        jm, scales = zc._jax_model(case)
        return jm, scales, zc._port_model(case)
    p = _paras(JaxParams, family)
    return (jax_build(p), [None],
            build_generator(_paras(ParametersLoader, family)).eval())


@pytest.fixture(scope="module")
def built():
    """Per family, once: the models, the seeded JAX params, their
    msgpack snapshot, the reference template and the mapper's variant
    keys."""
    cache = {}

    def get(family):
        if family not in cache:
            jm, scales, model = _models(family)
            x = zc._inputs([FAMILIES[family][2]])[0]
            params = zc._seeded(jm, x, scales)
            arch = pti.mapper_arch(FAMILIES[family][0])
            kw = pti.mapper_kwargs(_paras(ParametersLoader, family), arch)
            cache[family] = types.SimpleNamespace(
                jm=jm, scales=scales, model=model, x=x, params=params,
                arch=arch, kw=kw, template=pte.reference_template(model, arch),
                snapshot=serialization.to_bytes(params))
        return cache[family]
    return get


def _jax_pt(b, path):
    """The JAX package's reference ``.pt`` of the seeded params."""
    mean, std = pte.mean_std(b.model)
    tmpl = None if b.arch in ("rdst", "swinir") else b.template
    jte.save_torch_checkpoint(b.params, str(path), b.arch, mean=mean,
                              std=std, template=tmpl, **b.kw)
    return str(path)


def _forward(model, b, family):
    with torch.inference_mode():
        return model(torch.from_numpy(b.x), FAMILIES[family][3])


def _fresh(family):
    return _models(family)[2]


def _numpy(params):
    """The seeded params as numpy, as the port's msgpack reader gives
    them."""
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_template_passes_jax_verify(built, family):
    """The template, read by the JAX mapper, covers the JAX init's tree
    leaf for leaf; the port's mapper reads a seeded state dict in that
    layout into the JAX mapper's tree exactly."""
    b = built(family)
    zeros = {k: np.zeros(s, np.float32) for k, s in b.template.items()}
    converted = jti.convert_state_dict(zeros, b.arch, **b.kw)
    jti.verify_params_match(converted, b.params)
    rng = np.random.default_rng(5)
    sd = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in b.template.items()}
    want = jax.tree_util.tree_flatten_with_path(
        jti.convert_state_dict(sd, b.arch, **b.kw))[0]
    got = dict(pti._flatten(pti.convert_state_dict(sd, b.arch, **b.kw)))
    assert len(got) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(
            got[tuple(k.key for k in path)], np.asarray(v))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_pt_loads_bit_equal(built, tmp_path, family):
    """The JAX ``.pt`` of the seeded params loads strictly, by the tester's
    loader and by the trainer's ``pre_trained_g``; both forwards equal the
    msgpack-loaded model's bit for bit."""
    b = built(family)
    pt = _jax_pt(b, tmp_path / "ref.pt")
    snap = tmp_path / "ref.msgpack"
    snap.write_bytes(b.snapshot)
    p = _paras(ParametersLoader, family)
    want = _forward(load_well_trained_params(_fresh(family), p, str(snap),
                                             [4.0]), b, family)
    got = _forward(load_well_trained_params(_fresh(family), p, pt, [4.0]),
                   b, family)
    assert torch.equal(got, want)
    p.set("pre_trained_g", pt)
    stub = types.SimpleNamespace(paras=p, model=_fresh(family))
    assert SRTrainer.weights_init(stub).startswith("Init G with pre-trained")
    assert torch.equal(_forward(stub.model, b, family), want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_equals_jax_export(built, tmp_path, family):
    """The port's ``export_from_template`` equals the JAX one key by key
    (atol 0); a ``.pt`` that the port writes from its loaded module reads
    back through the JAX mapper into the seeded params."""
    b = built(family)
    mean, std = pte.mean_std(b.model)
    if b.arch not in ("rdst", "swinir"):
        want = jte.export_from_template(b.params, b.arch, b.template,
                                        mean=mean, std=std, **b.kw)
        got = pte.export_from_template(_numpy(b.params), b.arch,
                                       b.template, mean=mean, std=std,
                                       **b.kw)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = load_well_trained_params(_fresh(family), _paras(
        ParametersLoader, family), _jax_pt(b, tmp_path / "ref.pt"), [4.0])
    pt = tmp_path / "port.pt"
    pte.save_torch_checkpoint(model, str(pt), b.arch, template=b.template,
                              **b.kw)
    back = jti.load_torch_checkpoint(str(pt), b.arch, **b.kw)
    flat = dict(pti._flatten(back["params"]))
    for path, v in pti._flatten(_numpy(b.params)["params"]).items():
        np.testing.assert_array_equal(flat[path], v, err_msg=str(path))


def _raises_bn_resblock():
    with pytest.raises(KeyError, match="BatchNorm"):
        pti.convert_state_dict({"body.0.body.1.running_mean": np.zeros(4)},
                               "edsr")


def _raises_unmapped_key():
    for arch, family in (("rcan", "RCAN"), ("ipt", "IPT"),
                         ("dbpn", "DBPN"), ("zssr", "ZSSR")):
        with pytest.raises(KeyError, match=f"unmapped {family}"):
            pti.convert_state_dict({"nonesuch.weight": np.zeros(3)}, arch)


def _warns_prelu_slopes(built, tmp_path):
    """Slopes off 0.25 in a ``.pt`` are counted in a warning and dropped,
    as the JAX import drops them; the forward does not move."""
    b = built("srresnet")
    sd = torch.load(_jax_pt(b, tmp_path / "ref.pt"), weights_only=True)
    sd["head.1.activation.weight"] = torch.full((1,), 0.3)
    sd["body.0.body.1.weight"] = torch.full((1,), 0.25)
    pt = str(tmp_path / "prelu.pt")
    torch.save(sd, pt)
    p = _paras(ParametersLoader, "srresnet")
    with pytest.warns(UserWarning, match="1 of 2 PReLU slopes differ"):
        model = load_well_trained_params(_fresh("srresnet"), p, pt, [4.0])
    want = load_well_trained_params(_fresh("srresnet"), p,
                                    str(tmp_path / "ref.pt"), [4.0])
    assert torch.equal(_forward(model, b, "srresnet"),
                       _forward(want, b, "srresnet"))


def _aliases_load(built, tmp_path):
    """The JAX trainer's aliases (its ``_tl_arch``) load in the tester and
    the trainer alike; the JAX tester indexes the mapper table by the raw
    name and raises ``KeyError`` (a difference by design)."""
    b = built("convnext")
    pt = _jax_pt(b, tmp_path / "ref.pt")
    for name in ("convnet-large", "convnet-lite"):
        p = _paras(ParametersLoader, "convnext")
        p.set("feature_generator", name)
        load_well_trained_params(_fresh("convnext"), p, pt, [4.0])
        jp = _paras(JaxParams, "convnext")
        jp.set("feature_generator", name)
        with pytest.raises(KeyError):
            jax_loading.load_well_trained_params(None, jp, pt, [4.0])
    b = built("swinir")
    pt = _jax_pt(b, tmp_path / "sir.pt")
    p = _paras(ParametersLoader, "swinir")
    p.set("feature_generator", "swin")
    model = load_well_trained_params(_fresh("swinir"), p, pt, [4.0])
    assert torch.equal(_forward(model, b, "swinir"), _forward(
        load_well_trained_params(_fresh("swinir"), _paras(
            ParametersLoader, "swinir"), pt, [4.0]), b, "swinir"))


def _raises_metasr(built, tmp_path):
    p = zc._paras(ParametersLoader, {"feature_generator": "metasr"},
                  zc.METASR)
    with pytest.raises(NotImplementedError, match="JAX package has none"):
        load_well_trained_params(torch.nn.Identity(), p, "absent.pt", [4.0])


def _raises_misshaped_leaf(built, tmp_path):
    """A ``.pt`` of another width is refused naming the leaf, before any
    weight is copied."""
    b = built("rdn")
    sd = torch.load(_jax_pt(b, tmp_path / "ref.pt"), weights_only=True)
    sd["F0.weight"] = torch.zeros(12, 12, 5, 5)
    torch.save(sd, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="shape mismatch at .'F0'"):
        load_well_trained_params(_fresh("rdn"), _paras(
            ParametersLoader, "rdn"), str(tmp_path / "bad.pt"), [4.0])
    del sd["F0.weight"]
    torch.save(sd, str(tmp_path / "short.pt"))
    with pytest.raises(ValueError, match="missing=.*'F0'"):
        load_well_trained_params(_fresh("rdn"), _paras(
            ParametersLoader, "rdn"), str(tmp_path / "short.pt"), [4.0])


@pytest.mark.parametrize("check", [
    lambda b, t: _raises_bn_resblock(), lambda b, t: _raises_unmapped_key(),
    _warns_prelu_slopes, _aliases_load, _raises_metasr,
    _raises_misshaped_leaf],
    ids=["bn_resblock", "unmapped_key", "prelu_warning", "aliases",
         "metasr", "misshaped_leaf"])
def test_errors(built, tmp_path, check):
    check(built, tmp_path)


def test_modules_import_without_jax(tmp_path):
    """The mapper and writer run with jax, flax, msgpack and rdst_tpu
    blocked, as on the card's machine: a ``.pt`` written in the reference
    layout loads into a zeroed twin."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "optax", "rdst_tpu"):
    sys.modules[name] = None
import torch
from rdst_tpu_torch.checkpoint import torch_export as te, torch_import as ti
from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.models import build_generator
p = ParametersLoader({zc.CONFIG!r})
for k, v in {dict(zc.RD, feature_generator="rdn")!r}.items():
    p.set(k, v)
model, twin = build_generator(p), build_generator(p)
with torch.no_grad():
    for q in twin.parameters():
        q.zero_()
te.save_torch_checkpoint(model, {str(tmp_path / "g.pt")!r}, "rdn",
                         *te.mean_std(model),
                         template=te.reference_template(model, "rdn"))
load_well_trained_params(twin, p, {str(tmp_path / "g.pt")!r}, [4.0])
assert all(torch.equal(twin.state_dict()[k], v)
           for k, v in model.state_dict().items())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "flax", "msgpack", "rdst_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=zc.REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
