"""The port's serving bundle on the CPU: ``rdst_tpu_torch.serving.export``'s
``export_bundle``, ``ServingBundle`` and its CLI, against the JAX package.

* the manifest: the keys it shares with the JAX manifest hold the JAX
  ``build_serving_model`` meta's values, the entries are the exported
  points, and the port's own keys are there;
* ``params.msgpack`` restores leaf for leaf bitwise to the tree that the
  JAX exporter writes (``flax.serialization.to_bytes`` of the JAX
  ``build_serving_model`` params; no StableHLO is exported here);
* the bundle equals the port's ``LiveModel`` bitwise and the JAX
  ``LiveModel`` within 1e-5, and loads and predicts with the config file
  unreadable, ``weights/`` unreachable and jax, flax, msgpack and rdst_tpu
  unimportable;
* padding and chunks give the same slices at ``max_batch`` 2 and 8;
* unknown points, a JAX bundle, a rebuilt model whose routes differ and
  ``cuda`` without a card are refused; a bf16 bundle keeps its mode,
  softmax and routes whatever the environment says at load;
* the server (``--bundle --warmup``), the volume CLI and the export CLI;
* a captured forward holds the cached device tables it read, past their
  caches' evictions.

The tiny committed model at LR 24x28, as ``tests/test_serving.py`` uses it.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.serving import export

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
TINY_WEIGHTS = str(REPO / "weights" / "rdst_tiny2k_oasis_x4.msgpack")
LR = (24, 28)


def _paras(cls=ParametersLoader, **overrides):
    p = cls(TINY)
    p.set("well_trained_single_scale_model_g", TINY_WEIGHTS)
    for k, v in overrides.items():
        p.set(k, v)
    return p


@contextlib.contextmanager
def _jax_flags(**env):
    """Run the JAX package with its kernel flags as ``env`` says and put
    the environment back after (its builders write the flags)."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("RDST_TPU_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("RDST_TPU_")]:
            del os.environ[k]
        os.environ.update(saved)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle")
    export.export_bundle(_paras(), str(out), [LR], device="cpu")
    return out


@pytest.fixture(scope="module")
def served(bundle):
    return export.ServingBundle.load(str(bundle), max_batch=8, device="cpu")


@pytest.fixture(scope="module")
def live():
    return export.LiveModel(_paras(), max_batch=8, device="cpu")


@pytest.fixture(scope="module")
def slices():
    """Three slices with min 0 and max 1, so that ``sr_volume``'s min/max
    normalization of a volume of them gives them back bitwise."""
    x = np.random.default_rng(7).random((3,) + LR + (1,), dtype=np.float32)
    x[0, 0, 0], x[0, 0, 1] = 0.0, 1.0
    return x


@pytest.fixture(scope="module")
def outputs(served, live, slices):
    """The bundle's and the live model's predictions of ``slices`` (bucket
    8) and of their first slice (bucket 1)."""
    return {"served": served.predict(slices, 4.0),
            "live": live.predict(slices, 4.0),
            "served_1": served.predict(slices[:1], 4.0),
            "live_1": live.predict(slices[:1], 4.0)}


def test_manifest_matches_jax(bundle):
    from rdst_tpu.config import ParametersLoader as JaxParams
    from rdst_tpu.serving import export as jax_export

    man = json.loads((bundle / "MANIFEST.json").read_text())
    # interpret mode: the JAX package names the kernel mode its TPU
    # programs would run, as the port names the one its kernels run
    with _jax_flags(RDST_TPU_PALLAS_INTERPRET="1"):
        _, _, _, meta = jax_export.build_serving_model(_paras(JaxParams))
    shared = set(meta) - {"jax_version"}
    assert {k: man[k] for k in shared} == {k: meta[k] for k in shared}
    assert man["entries"] == [{"scale": 4.0, "lr_hw": list(LR)}]
    assert man["runtime"] == "torch" and man["executable"] == "cuda_graph"
    assert man["routes"] == ["fused_swin_block"] * 2
    assert man["pallas_quant"] is None and man["norm"] is None
    cfg = man["config"]
    assert cfg["feature_generator"] == "rdst" and cfg["rdst_embed_dim"] == 30
    assert cfg["pallas_kernels"] == "rdstb" and cfg["pallas_quant"] == "off"
    assert not any(k.startswith(("well_trained", "pre_trained"))
                   or k.endswith(("_dir", "_folder")) for k in cfg)
    assert sorted(p.name for p in bundle.iterdir()) == ["MANIFEST.json",
                                                        "params.msgpack"]


def test_params_match_jax_exporter(bundle):
    """The JAX exporter writes ``to_bytes(device_get(params))``
    (rdst_tpu/serving/export.py:221-222); flax reads the port's file to
    the same tree, leaf for leaf, bitwise."""
    import jax
    from flax import serialization
    from flax.traverse_util import flatten_dict

    from rdst_tpu.config import ParametersLoader as JaxParams
    from rdst_tpu.serving import export as jax_export

    with _jax_flags():
        _, params, _, _ = jax_export.build_serving_model(_paras(JaxParams))
    want = flatten_dict(serialization.msgpack_restore(
        serialization.to_bytes(jax.device_get(params))))
    got = flatten_dict(serialization.msgpack_restore(
        (bundle / "params.msgpack").read_bytes()))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_bundle_matches_live_models(served, outputs, slices):
    from rdst_tpu.config import ParametersLoader as JaxParams
    from rdst_tpu.serving import export as jax_export

    got = outputs["served"]
    assert got.shape == (3, 96, 112, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, outputs["live"])
    np.testing.assert_array_equal(outputs["served_1"], outputs["live_1"])
    with _jax_flags():
        ref = jax_export.LiveModel(_paras(JaxParams), max_batch=8)
        want = ref.predict(slices, 4.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bundle_is_self_contained(bundle, outputs, slices, tmp_path):
    """Loading and predicting read the bundle directory only: a copy
    served from another directory, with ParametersLoader's file read,
    everything under weights/ and config_files/, and jax, flax, msgpack
    and rdst_tpu blocked."""
    import shutil

    copy = tmp_path / "copy"
    shutil.copytree(bundle, copy)
    np.save(tmp_path / "x.npy", slices[0, ..., 0])  # the rank-2 form
    np.save(tmp_path / "want.npy", outputs["served_1"])
    script = f"""
import builtins, io, os, sys
for name in ("jax", "jaxlib", "flax", "msgpack", "rdst_tpu"):
    sys.modules[name] = None
import numpy as np
blocked = ({str(REPO / "weights")!r}, {str(REPO / "config_files")!r})
real_open, real_io_open = builtins.open, io.open

def guard(path):
    p = os.path.abspath(os.fspath(path)) if isinstance(path, (str, bytes, os.PathLike)) else ""
    if isinstance(p, bytes):
        p = p.decode()
    if p.startswith(blocked) or p.endswith(".ini"):
        raise PermissionError("blocked: " + p)

def opener(path, *a, **k):
    guard(path)
    return real_open(path, *a, **k)

builtins.open = opener
io.open = opener
from rdst_tpu_torch.config import ParametersLoader

def no_file(self, config_file):
    raise PermissionError("ParametersLoader read " + str(config_file))

ParametersLoader.load = no_file
from rdst_tpu_torch.serving.export import ServingBundle
b = ServingBundle.load("copy", max_batch=8, device="cpu")
got = b.predict(np.load("x.npy"), 4.0)
assert np.array_equal(got, np.load("want.npy")), np.abs(got - np.load("want.npy")).max()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "msgpack", "rdst_tpu")
                and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_buckets_pad_and_chunk(bundle, served, outputs, slices):
    """Three slices at max_batch 2 run as a full chunk and a padded one,
    and give the slices that one bucket of 8 gives."""
    small = export.ServingBundle.load(str(bundle), max_batch=2, device="cpu")
    assert small.buckets == (1, 2) and served.buckets == (1, 8)
    got = small.predict(slices, 4.0)
    assert got.shape == outputs["served"].shape == (3, 96, 112, 1)
    np.testing.assert_allclose(got, outputs["served"], rtol=0, atol=1e-6)


def test_unknown_points_raise(served):
    with pytest.raises(ValueError, match=r"available: \[\(4.0, \(24, 28\)\)"):
        served.predict(np.zeros(LR, np.float32), 2.0)
    with pytest.raises(ValueError, match=r"no entry for scale 4.0 @ LR "
                       r"\(16, 16\); available"):
        served.predict(np.zeros((16, 16), np.float32), 4.0)
    with pytest.raises(ValueError, match="channel"):
        served.predict(np.zeros((1,) + LR + (3,), np.float32), 4.0)


def test_jax_bundle_refused(tmp_path):
    """A manifest the JAX exporter writes (StableHLO entries, no runtime)
    is refused, naming the port's exporter."""
    from rdst_tpu.config import ParametersLoader as JaxParams
    from rdst_tpu.serving import export as jax_export

    with _jax_flags():
        _, _, _, meta = jax_export.build_serving_model(_paras(JaxParams))
    meta["entries"] = [{"scale": 4.0, "lr_hw": list(LR),
                        "file": "sr_x4_24x28.shlo", "platforms": ["cpu",
                                                                  "tpu"]}]
    (tmp_path / "MANIFEST.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="StableHLO.*sr_x4_24x28.shlo.*"
                       "python -m rdst_tpu_torch.serving.export"):
        export.ServingBundle.load(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="rdst_tpu_torch.serving"):
        export.ServingBundle.load(str(tmp_path / "none"), device="cpu")


def test_rebuilt_routes_must_match(bundle, tmp_path):
    import shutil

    copy = tmp_path / "copy"
    shutil.copytree(bundle, copy)
    man = json.loads((copy / "MANIFEST.json").read_text())
    man["routes"] = ["plain"] * 2
    (copy / "MANIFEST.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="routes"):
        export.ServingBundle.load(str(copy), device="cpu")


def test_bf16_bundle_keeps_its_kernel_keys(tmp_path, monkeypatch):
    """A bf16 bundle in mode pair with the stable_mm softmax (the tiny
    model has no RDSTB adapter for mode rdstb) loads with that mode,
    softmax and routes while the environment asks for others, and
    serves as the live model built from its config does."""
    over = dict(inference_dtype="bfloat16", pallas_kernels="pair",
                pallas_softmax="stable_mm")
    export.export_bundle(_paras(**over), str(tmp_path), [LR], device="cpu")
    live = export.LiveModel(_paras(**over), max_batch=8, device="cpu")
    monkeypatch.setenv("RDST_TORCH_KERNELS", "swin")
    monkeypatch.setenv("RDST_TORCH_SOFTMAX", "clamp")
    monkeypatch.setenv("RDST_TORCH_QUANT", "qkv")
    b = export.ServingBundle.load(str(tmp_path), max_batch=8, device="cpu")
    m = b.manifest
    assert m["dtype"] == "bfloat16" and m["pallas_kernels"] == "pair"
    assert m["pallas_softmax"] == "stable_mm" and m["pallas_quant"] is None
    assert m["routes"] == ["fused_swin_pair"] * 2
    assert (b.model.kernel_mode, b.model.softmax, b.model.routes) == (
        "pair", "stable_mm", ["fused_swin_pair"] * 2)
    x = np.random.default_rng(9).random((1,) + LR, dtype=np.float32)
    np.testing.assert_array_equal(b.predict(x, 4.0), live.predict(x, 4.0))


def test_server_serves_bundle(bundle, outputs, slices, monkeypatch):
    """``--bundle --warmup`` warms every entry and bucket, then answers
    health, metadata (the bundle's manifest) and predict."""
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer, main

    seen = {}

    def serve(self):
        self.start_background()
        client = SRClient(f"http://127.0.0.1:{self.port}")
        seen["health"] = client.health()
        seen["meta"] = client.metadata()
        seen["y"] = client.predict(slices[:1], 4.0)
        raise KeyboardInterrupt

    monkeypatch.setattr(InferenceServer, "serve_forever", serve)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--bundle", str(bundle), "--platform", "cpu", "--port", "0",
              "--max-batch", "1", "--warmup"])
    assert "warmed 1 manifest entries" in out.getvalue()
    assert seen["health"] == {"status": "ok"}
    man = json.loads((bundle / "MANIFEST.json").read_text())
    assert seen["meta"] == dict(man, device="cpu")
    np.testing.assert_array_equal(seen["y"], outputs["served_1"])
    with pytest.raises(ValueError, match="overrides"):
        main(["--bundle", str(bundle), "--platform", "cpu", "x=1"])


def test_volume_cli_bundle(bundle, outputs, slices, tmp_path):
    """The volume CLI with ``--bundle`` round-trips a NIfTI volume and
    gives what ``sr_volume`` gives on the live model: the volume's slices
    are ``slices``, whose live prediction is known."""
    from rdst_tpu_torch.data import io as nio
    from rdst_tpu_torch.serving.volume import main as volume_main
    from rdst_tpu_torch.serving.volume import sr_volume

    class Known:
        def predict(self, x, scale):
            np.testing.assert_array_equal(x, slices)
            return outputs["live"]

    vol = np.moveaxis(slices[..., 0], 0, 2)  # (24, 28, 3), axis 2
    src, dst = tmp_path / "in.nii", tmp_path / "out.nii"
    nio.save(str(src), vol)
    volume_main(["--bundle", str(bundle), "--in", str(src), "--out",
                 str(dst), "--platform", "cpu", "--max-batch", "8"])
    got = nio.load(str(dst)).get_fdata()
    assert got.shape == (96, 112, 3)
    np.testing.assert_array_equal(got, sr_volume(Known(), vol, 4.0))


def test_export_cli_writes_the_bundle(bundle, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        export.main(["--config-file", TINY, "--out", str(tmp_path),
                     "--lr-hw", str(LR[0]), str(LR[1]), "--platform", "cpu",
                     f"well_trained_single_scale_model_g='{TINY_WEIGHTS}'"])
    want = json.loads((bundle / "MANIFEST.json").read_text())
    assert json.loads(out.getvalue()) == want
    assert json.loads((tmp_path / "MANIFEST.json").read_text()) == want
    assert (tmp_path / "params.msgpack").read_bytes() == (
        bundle / "params.msgpack").read_bytes()


def test_cuda_without_card_raises(bundle):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks a machine without one")
    with pytest.raises(RuntimeError, match="cuda"):
        export.ServingBundle.load(str(bundle))  # default device: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        export.export_bundle(_paras(), str(bundle / "x"), [LR])


def test_capture_holds_its_tables(bundle):
    """A graph keeps raw pointers to the device tables its capture read.
    ``_held_forward`` (the forward a capture records) returns the kernel
    plans and the cached tables the forward used, hits included, so that
    a graph outlives their caches: after more geometries than a cache
    holds and after every cache is emptied, the held tables are still
    there, unchanged, while the caches make new ones (and a table nothing
    holds is freed). A fresh model builds its plans in this forward, so
    it reads the index and mask tables here (later forwards read the
    plans' biases, made from them)."""
    import gc
    import weakref

    from rdst_tpu_torch.device import clear_device_tables, held_tables
    from rdst_tpu_torch.models.meta_upscale import _device_plan
    from rdst_tpu_torch.models.rdst import _reflect_index_on
    from rdst_tpu_torch.nn.swin import _index_tensor, _mask_tensor

    cpu = torch.device("cpu")
    x = torch.zeros((1,) + LR + (1,))  # 28 columns reflect-pad to 32
    model = export.ServingBundle.load(str(bundle), device="cpu").model
    with torch.inference_mode():
        y, plans, tables = export._held_forward(model, x, 4.0)
    assert y.dtype == torch.float32 and y.shape == (1, 96, 112, 1)
    assert len(plans) == 8  # the tiny model's 8 f32 blocks
    pad = _reflect_index_on(28, 32, cpu)
    used = [pad, _index_tensor(8, cpu), _mask_tensor(24, 32, 8, 4, cpu)]
    assert [any(t is u for t in tables) for u in used] == [True] * 3
    values = [u.clone() for u in used]
    for n in range(100, 165):  # 65 geometries evict the 64-entry cache
        _reflect_index_on(n, n + 1, cpu)
    assert _reflect_index_on(28, 32, cpu) is not pad
    clear_device_tables()
    gc.collect()
    assert _index_tensor(8, cpu) is not used[1]
    for u, v in zip(used, values):
        assert any(t is u for t in tables) and torch.equal(u, v)
    loose = weakref.ref(_reflect_index_on(7, 9, cpu))
    clear_device_tables()
    gc.collect()
    assert loose() is None
    with held_tables() as held:  # MetaSR's plan, a hit recorded too
        plan = _device_plan(5, 6, 1.5, cpu)
        assert _device_plan(5, 6, 1.5, cpu) is plan
    assert held == [plan, plan]
    assert export.CapturedForward._fields == ("graph", "x", "y", "plans",
                                              "tables")


def test_capture_fault_names_the_op():
    """A capture that fails raises again at its end, over the first
    error: the message names the first error's innermost frame outside
    torch (the op) and that error."""

    def slope_per_call(t):
        return t * torch.tensor(0.2, device=t.device).item() + float("x")

    try:
        try:
            slope_per_call(torch.zeros(2))
        except ValueError:
            raise RuntimeError("capture ended after an error")
    except RuntimeError as e:
        msg = export._capture_fault(e)
    assert "test_torch_bundle.py" in msg and "slope_per_call" in msg
    assert msg.endswith("ValueError: could not convert string to float: 'x'")
