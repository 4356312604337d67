"""Port's config and weights: ``rdst_tpu_torch.config`` and
``rdst_tpu_torch.checkpoint`` against the JAX package and flax.

* every shipped ``.ini`` parses to the same values in both packages;
* the stdlib msgpack reader decodes the committed flagship snapshot to
  exactly what ``flax.serialization.msgpack_restore`` returns;
* the weight carry-over equals ``export_rdstsr`` of the JAX package, and
  the port's RDSTSR takes it with every key matched.
"""

import json
import pathlib
import struct

import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from rdst_tpu.checkpoint import loading as jax_loading
from rdst_tpu.checkpoint.torch_export import export_rdstsr as jax_export
from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu_torch.checkpoint import loading
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.config import ParametersLoader

REPO = pathlib.Path(__file__).resolve().parents[1]
SNAPSHOT = REPO / "weights" / "rdst_e1_40k_best_oasis20_x4.msgpack"
CONFIG = REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini"
CONFIGS = sorted(p.name for p in (REPO / "config_files").glob("*.ini"))


@pytest.fixture(scope="module")
def snapshot_bytes():
    return SNAPSHOT.read_bytes()


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_config_parses_like_jax(name):
    path = str(REPO / "config_files" / name)
    mine, theirs = ParametersLoader(path), JaxParams(path)
    assert mine.names == theirs.names
    assert mine.to_dict() == theirs.to_dict()


def test_config_overrides_parse_like_ini():
    p = ParametersLoader(str(CONFIG))
    p.apply_overrides(["batch_size=16", "well_trained_single_scale_model_g="
                       "'weights/x.msgpack'"])
    assert p.batch_size == 16
    assert p.get("well_trained_single_scale_model_g") == "weights/x.msgpack"
    with pytest.raises(ValueError, match="KEY=VALUE"):
        p.apply_overrides(["no_equals_sign"])


def test_reader_matches_flax_on_flagship_snapshot(snapshot_bytes):
    want = flatten_dict(serialization.msgpack_restore(snapshot_bytes))
    got = mr.flatten(mr.msgpack_restore(snapshot_bytes))
    assert len(got) == len(want) == 750
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


def test_reader_round_trips_flax_to_bytes():
    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "i": np.array([1, -2], np.int32)},
            "b": np.zeros((0, 4), np.float64), "s": np.ones((), np.float32)}
    got = mr.msgpack_restore(serialization.msgpack_serialize(tree))
    for path, v in mr.flatten(tree).items():
        g = mr.flatten(got)[path]
        assert g.dtype == v.dtype and g.shape == v.shape
        np.testing.assert_array_equal(g, v)


def test_reader_refuses_other_ext_codes():
    # fixext 1 with code 3 (flax's numpy-scalar record)
    data = b"\x81\xa1a" + b"\xd4\x03\x00"
    with pytest.raises(mr.MsgpackFormatError, match="ext code 3"):
        mr.msgpack_restore(data)


def test_reader_refuses_chunked_arrays_and_truncation(snapshot_bytes):
    chunked = b"\x81\xb9__msgpack_chunked_array__\xc3"
    with pytest.raises(mr.MsgpackFormatError, match="chunked"):
        mr.msgpack_restore(chunked)
    with pytest.raises(mr.MsgpackFormatError, match="truncated"):
        mr.msgpack_restore(snapshot_bytes[:1000])
    with pytest.raises(mr.MsgpackFormatError, match="trailing"):
        mr.msgpack_restore(b"\xc0\xc0")


@pytest.mark.parametrize("data,want", [
    (b"\x7f", 127), (b"\xe0", -32), (b"\xcc\xff", 255), (b"\xd1\xff\x00", -256),
    (b"\xcb" + struct.pack(">d", 1.5), 1.5), (b"\xc2", False),
    (b"\x92\x01\xa1x", [1, "x"]), (b"\xc4\x02ab", b"ab")])
def test_reader_scalar_types(data, want):
    assert mr.unpackb(data) == want


@pytest.mark.parametrize("mean,std", [((0.0,), (1.0,)), ((0.25,), (2.0,))])
def test_carry_over_equals_export_rdstsr(snapshot_bytes, mean, std):
    want = jax_export(serialization.msgpack_restore(snapshot_bytes), mean, std)
    got = export_rdstsr(mr.msgpack_restore(snapshot_bytes), mean, std)
    assert len(got) == len(want) == 754
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)


def test_port_model_loads_flagship_strictly():
    from rdst_tpu_torch.models import build_generator

    paras = ParametersLoader(str(CONFIG))
    model = build_generator(paras)
    loading.load_well_trained_params(model, paras, str(SNAPSHOT), [4.0])
    sd = export_rdstsr(mr.read_snapshot(str(SNAPSHOT)))
    for k, v in model.state_dict().items():
        assert torch.equal(v, torch.from_numpy(sd[k].copy())), k


def test_pt_path_prefers_msgpack_sibling(tmp_path):
    from rdst_tpu_torch.models import build_generator

    paras = ParametersLoader(str(CONFIG))
    model = build_generator(paras)
    pt = str(SNAPSHOT.with_suffix(".pt"))
    loading.load_well_trained_params(model, paras, pt, [4.0])
    with pytest.raises(NotImplementedError, match="torch-import"):
        loading.load_well_trained_params(model, paras,
                                         str(tmp_path / "ref.pth"), [4.0])


def test_model_path_precedence_matches_jax():
    cases = [
        {"well_trained_model_g_x4": "x4.msgpack"},
        {"well_trained_model_g_x4": "x4", "well_trained_model_mdsr": "m"},
        {"well_trained_model_mdsr": "m", "well_trained_model_metasr": "meta"},
        {"well_trained_single_scale_model_g": "s", "well_trained_model_metasr": "m"},
        {},
    ]
    for d in cases:
        assert (loading.resolve_model_path(ParametersLoader.from_dict(d))
                == jax_loading.resolve_model_path(JaxParams.from_dict(d)))


def test_sidecar_and_norm_stats(tmp_path):
    assert loading.read_stats_sidecar(str(SNAPSHOT)) == json.loads(
        SNAPSHOT.with_suffix(".stats.json").read_text())
    assert loading.resolve_norm_stats(None, str(SNAPSHOT)) == ([0.0], [1.0])
    assert loading.read_stats_sidecar(None) is None
    with pytest.raises(NotImplementedError, match="tester slice"):
        loading.resolve_norm_stats(None, str(tmp_path / "none.msgpack"))


@pytest.mark.parametrize("env,want", [("auto", "clamp"), ("stable", "stable"),
                                      ("", "")])
def test_softmax_auto_resolution_matches_jax(monkeypatch, env, want):
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", env)
    got = loading.resolve_pallas_softmax(str(SNAPSHOT), env)
    assert got == jax_loading.resolve_pallas_softmax(str(SNAPSHOT)) == want


def test_softmax_auto_unstamped_is_stable_bc(tmp_path, monkeypatch):
    """A checkpoint without an audited logit stamp resolves 'auto' to the
    exact 'stable_bc', as ``rdst_tpu/kernels/swin_block.py:111`` does; the
    bf16 model built for the flagship keeps the resolved 'clamp'."""
    import torch

    from rdst_tpu_torch.models import build_generator

    bare = str(tmp_path / "bare.msgpack")
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "auto")
    assert loading.resolve_pallas_softmax(bare, "auto") == "stable_bc"
    assert jax_loading.resolve_pallas_softmax(bare) == "stable_bc"
    p = ParametersLoader(CONFIG)
    p.set("well_trained_single_scale_model_g", bare)
    assert build_generator(p, dtype=torch.bfloat16).softmax == "stable_bc"
    p.set("well_trained_single_scale_model_g", str(SNAPSHOT))
    assert build_generator(p, dtype=torch.bfloat16).softmax == "clamp"


def test_export_kernel_flags(monkeypatch):
    """The port's counterpart of ``export_kernel_flags`` resolves the
    keys (config, then env, then default) and writes no env flag."""
    import os

    from rdst_tpu_torch.kernels import window_attention as wa

    monkeypatch.setenv(wa.ENV_KERNELS, "pack")
    monkeypatch.setenv(wa.ENV_QUANT, "all")
    monkeypatch.setenv(wa.ENV_SOFTMAX, "")
    env = dict(os.environ)
    flags = wa.kernel_flags({"pallas_kernels": "swin", "pallas_quant": "off",
                             "pallas_softmax": "auto"})
    assert flags == wa.KernelFlags("swin", frozenset(), "auto")
    assert wa.kernel_flags({"pallas_kernels": "off"}).kernels == ""
    assert wa.kernel_flags({"pallas_kernels": ""}).kernels == ""
    # absent keys take the env flags
    assert wa.kernel_flags({}) == wa.KernelFlags(
        "pack", frozenset({"qkv", "mlp", "proj", "conv"}), "")
    assert dict(os.environ) == env
    monkeypatch.setenv(wa.ENV_KERNELS, "")
    assert wa.kernel_flags({"pallas_quant": "0"}).kernels == "rdstb"
    monkeypatch.setenv(wa.ENV_KERNELS, "off")
    assert wa.kernel_flags({"pallas_quant": "0"}).kernels == ""
    with pytest.raises(ValueError, match="pallas_softmax"):
        wa.kernel_flags({"pallas_softmax": "bogus"})
    with pytest.raises(ValueError, match="pallas_kernels"):
        wa.kernel_flags({"pallas_kernels": "block"})
