"""The port's serving path on the CPU: ``rdst_tpu_torch.serving``.

* the HTTP server answers healthz/metadata, and served predictions equal
  the direct ``LiveModel.predict`` (within 1e-6: same batch shapes, same
  process);
* the batcher coalesces a concurrent burst;
* the port imports and serves with jax, flax, msgpack and rdst_tpu made
  unimportable, as on a machine that has none of them, in float32 and in
  bfloat16 (every kernel module imported);
* ``inference_dtype = 'bfloat16'`` serves the flagship on the CPU through
  the plain versions of its kernels; the manifest names the dtype, the
  mode, the resolved softmax variant and the kernel each RDSTB runs;
* asking for the device ``cuda`` where there is none raises, and the
  options this slice leaves out raise instead of running something else;
* ``residual_scale > 0`` (MetaSR's bicubic blend) and ``sr_volume`` agree
  with the JAX package's within 1e-5 (the tiny committed model).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from rdst_tpu.serving import export as jax_export
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.serving import export
from rdst_tpu_torch.serving.client import SRClient
from rdst_tpu_torch.serving.server import Batcher, InferenceServer, main

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config_files" / "rdst_e1_40k_oasis20_x4.ini")
WEIGHTS = str(REPO / "weights" / "rdst_e1_40k_best_oasis20_x4.msgpack")
LR = (16, 24)


def _paras(**overrides):
    p = ParametersLoader(CONFIG)
    p.set("well_trained_single_scale_model_g", WEIGHTS)
    for k, v in overrides.items():
        p.set(k, v)
    return p


def _port_env():
    return {k: v for k, v in os.environ.items() if k.startswith("RDST_TORCH_")}


@pytest.fixture(scope="module")
def live():
    return export.LiveModel(_paras(), max_batch=8, device="cpu")


def test_live_model_manifest(live):
    m = live.manifest
    assert m["feature_generator"] == "rdst" and m["dtype"] == "float32"
    assert m["scales"] == [4.0] and m["layout"] == "NHWC"
    assert m["pallas_kernels"] == "rdstb"
    assert m["pallas_softmax"] == "clamp"  # 'auto' against the 25.4 stamp
    assert m["device"] == "cpu" and live.buckets == (1, 8)


def test_models_keep_their_own_kernel_mode(live):
    """Building a model resolves the config's kernel keys once and writes
    no env flag: a second model built with the kernels off leaves the
    served one on the kernel path."""
    env = _port_env()
    plain = export.LiveModel(_paras(pallas_kernels="off"), max_batch=8,
                             device="cpu")
    assert _port_env() == env
    assert plain.manifest["pallas_kernels"] is None
    assert not any(getattr(m, "use_kernel", False)
                   for m in plain.model.modules())
    assert live.manifest["pallas_kernels"] == "rdstb"
    blocks = [m for m in live.model.modules() if hasattr(m, "use_kernel")]
    assert len(blocks) == 48 and all(m.use_kernel for m in blocks)


def test_server_round_trip(live):
    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=8)
    srv.start_background()
    try:
        client = SRClient(f"http://127.0.0.1:{srv.port}")
        assert client.health() == {"status": "ok"}
        meta = client.metadata()
        assert meta["model_name"] == "RDST_E1_40K_O20"
        assert meta["scales"] == [4.0]
        x = np.random.default_rng(0).random((3,) + LR, dtype=np.float32)
        for xs in (x[:1], x):
            got = client.predict(xs, 4.0)
            want = live.predict(xs, 4.0)
            assert got.shape == (len(xs), 64, 96, 1)
            assert np.abs(got - want).max() <= 1e-6
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/predict?scale=2",
            data=b"not npy", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
    finally:
        srv.close()


def test_close_before_serving_returns(live):
    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=8)
    t = threading.Thread(target=srv.close, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive()


def test_unserved_scale_raises(live):
    with pytest.raises(ValueError, match="scale"):
        live.predict(np.zeros(LR, np.float32), 2.0)


class _Counting:
    """Predictor stub: records dispatched batch sizes."""

    def __init__(self):
        self.sizes = []

    def predict(self, x, scale):
        self.sizes.append(x.shape[0])
        time.sleep(0.01)
        return x * scale


def test_batcher_coalesces_a_burst():
    pred = _Counting()
    batcher = Batcher(pred, max_batch=8, batch_wait_ms=200)
    barrier = threading.Barrier(8)
    outs = [None] * 8

    def one(i):
        barrier.wait()
        outs[i] = batcher.submit(np.full((1, 4, 4, 1), i, np.float32), 2.0)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert sum(pred.sizes) == 8 and len(pred.sizes) < 8
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full((1, 4, 4, 1), 2.0 * i))


@pytest.mark.parametrize("spec,max_batch", [
    (None, 64), ("1,8,64", 64), ("pow2", 64), ("1,8,64", 16), ("3,5", 8)])
def test_bucket_ladder_matches_jax(spec, max_batch):
    want = jax_export.resolve_buckets(max_batch, spec)
    assert export.resolve_buckets(max_batch, spec) == want
    for n in (1, 2, 7, 8, 9, 63, 64, 65):
        assert export._bucket(n, want) == jax_export._bucket(n, want)


@pytest.mark.parametrize("shape", [(5, 6), (2, 5, 6), (2, 5, 6, 1)])
def test_canon_input_matches_jax(shape):
    x = np.ones(shape, np.float64)
    np.testing.assert_array_equal(export._canon_input(x),
                                  jax_export._canon_input(x))


def test_bucketed_predict_pads_and_slices():
    sizes = []

    def fn(blk):
        sizes.append(blk.shape[0])
        return blk + 1

    x = np.arange(11, dtype=np.float32).reshape(11, 1, 1, 1)
    out = export._bucketed_predict(fn, x, (1, 8))
    np.testing.assert_array_equal(out, x + 1)
    assert sizes == [8, 8]


def test_import_isolation_serves_without_jax():
    """A GPU host for the port need not have jax, flax, optax, msgpack,
    tabulate or matplotlib: the port must import (the evaluation,
    auxiliary-trainer, data-parallel, profiling, FLOP and PatchGAN modules
    included) and serve, on one device and over a data axis of two, with
    all of them (and rdst_tpu) unimportable."""
    script = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "tabulate",
             "matplotlib", "rdst_tpu"):
    sys.modules[name] = None
import numpy as np
import rdst_tpu_torch
import rdst_tpu_torch.runners.seg_eval, rdst_tpu_torch.utils.figures
import rdst_tpu_torch.runners.train_seg_unet
import rdst_tpu_torch.runners.train_vgg_features
import rdst_tpu_torch.parallel.collectives, rdst_tpu_torch.parallel.launch
import rdst_tpu_torch.parallel.probe, rdst_tpu_torch.losses.patchgan
import rdst_tpu_torch.utils.flops, rdst_tpu_torch.utils.profiling
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.serving.export import LiveModel
p = ParametersLoader({CONFIG!r})
p.set("well_trained_single_scale_model_g", {WEIGHTS!r})
live = LiveModel(p, max_batch=8, device="cpu")
y = live.predict(np.random.default_rng(0).random((2, 16, 24), dtype=np.float32), 4.0)
assert y.shape == (2, 64, 96, 1) and np.isfinite(y).all(), y.shape
p.set("mesh_shape", [2])
live2 = LiveModel(p, max_batch=8, device="cpu")
assert live2.manifest["mesh"] == {{"data": 2}}, live2.manifest
y2 = live2.predict(np.random.default_rng(0).random((2, 16, 24), dtype=np.float32), 4.0)
assert np.abs(y2 - y).max() < 1e-5
p.set("mesh_shape", None)
import rdst_tpu_torch.kernels.rdstb_block, rdst_tpu_torch.kernels.swin_pair
p.set("inference_dtype", "bfloat16")
live = LiveModel(p, max_batch=8, device="cpu")
y = live.predict(np.random.default_rng(0).random((1, 16, 24), dtype=np.float32), 4.0)
assert live.manifest["dtype"] == "bfloat16" and y.dtype == np.float32
assert y.shape == (1, 64, 96, 1) and np.isfinite(y).all(), y.shape
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "msgpack", "tabulate",
                 "matplotlib", "rdst_tpu") and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks a machine without one")
    from rdst_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        export.LiveModel(_paras(), max_batch=8)  # default device: cuda


@pytest.mark.parametrize("key,value,match", [
    ("pallas_quant", "mlp,conv", "int8"),
    ("pallas_quant", "qkv,proj", "int8"),
])
def test_unported_serving_options_raise(monkeypatch, key, value, match):
    """Every int8 group is ported: each subset builds in bf16 and the
    metadata reports its groups; a group the JAX package does not know
    raises (f32 drops int8, as the JAX precise path does:
    test_torch_repairs.py)."""
    monkeypatch.setenv("RDST_TORCH_QUANT", "")
    extra = {"inference_dtype": "bfloat16"}
    _, meta = export.build_serving_model(_paras(**{key: value}, **extra),
                                         device="cpu")
    assert meta[key] == sorted(value.split(","))
    assert meta["routes"] == ["fused_rdstb"] * 8
    with pytest.raises(ValueError, match=match):
        export.build_serving_model(
            _paras(**{key: value + ",fc3"}, **extra), device="cpu")


def test_bf16_live_model_serves_flagship():
    """The flagship config with ``inference_dtype='bfloat16'`` on the CPU:
    every RDSTB routed to the RDSTB kernel (its plain version here), the
    softmax 'auto' resolved to clamp by the 25.412 stamp, float32 numpy in
    and out, close to the float32 model (bf16 noise: < 0.05 max and
    < 0.005 mean, relative)."""
    from rdst_tpu_torch.kernels import rdstb_block

    live = export.LiveModel(_paras(inference_dtype="bfloat16"), max_batch=8,
                            device="cpu")
    m = live.manifest
    assert m["dtype"] == "bfloat16" and m["pallas_kernels"] == "rdstb"
    assert m["pallas_softmax"] == "clamp"
    assert m["routes"] == ["fused_rdstb"] * 8
    x = np.random.default_rng(3).random((2,) + LR, dtype=np.float32)
    before = rdstb_block.run_rdstb.launches
    y = live.predict(x, 4.0)
    assert rdstb_block.run_rdstb.launches == before  # CPU: plain versions
    assert y.dtype == np.float32 and y.shape == (2, 64, 96, 1)
    ref = export.LiveModel(_paras(), max_batch=8, device="cpu").predict(
        x, 4.0)
    d = np.abs(y - ref) / np.abs(ref).max()
    assert d.max() < 0.05 and d.mean() < 0.005


@pytest.mark.parametrize("mode", ["pair", "swin", "pack", "off"])
def test_bf16_manifest_names_routes(mode):
    live = export.LiveModel(_paras(inference_dtype="bfloat16",
                                   pallas_kernels=mode), max_batch=8,
                            device="cpu")
    route = {"pair": "fused_swin_pair", "swin": "fused_swin_block",
             "pack": "fused_swin_block", "off": "plain"}[mode]
    assert live.manifest["routes"] == [route] * 8
    assert live.manifest["pallas_kernels"] == (None if mode == "off"
                                               else mode)


def test_missing_weights_path_raises():
    p = ParametersLoader(CONFIG)
    with pytest.raises(ValueError, match="well_trained"):
        export.build_serving_model(p, device="cpu")


def test_server_main_bundle_raises():
    """``--bundle`` serves an exported bundle (tests/test_torch_bundle.py);
    a directory that holds none raises, naming the exporter."""
    with pytest.raises(FileNotFoundError,
                       match="MANIFEST.json.*rdst_tpu_torch.serving.export"):
        main(["--bundle", "somewhere"])


def test_server_main_config_arguments(monkeypatch):
    """main() builds the model from --config-file plus KEY=VALUE
    overrides on the requested platform, then serves until interrupted."""
    seen = {}

    def fake_serve(self):
        seen["port"] = self.port
        seen["meta"] = json.loads(json.dumps(self.batcher.predictor.manifest))
        raise KeyboardInterrupt

    monkeypatch.setattr(InferenceServer, "serve_forever", fake_serve)
    main(["--config-file", CONFIG, "--port", "0", "--platform", "cpu",
          "--max-batch", "8", f"well_trained_single_scale_model_g='{WEIGHTS}'"])
    assert seen["port"] > 0 and seen["meta"]["device"] == "cpu"
    main(["--config-file", CONFIG, "--port", "0", "--platform", "cpu",
          "--max-batch", "8", f"well_trained_single_scale_model_g='{WEIGHTS}'",
          "inference_dtype='bfloat16'"])
    assert seen["meta"]["dtype"] == "bfloat16"
    assert seen["meta"]["routes"] == ["fused_rdstb"] * 8


TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
TINY_WEIGHTS = str(REPO / "weights" / "rdst_tiny2k_oasis_x4.msgpack")


@pytest.fixture(scope="module")
def blended():
    """The tiny model with ``residual_scale = 0.5`` in both packages."""
    from rdst_tpu.config import ParametersLoader as JaxParams

    def paras(cls):
        p = cls(TINY)
        p.set("well_trained_single_scale_model_g", TINY_WEIGHTS)
        p.set("residual_scale", 0.5)
        return p

    return (export.LiveModel(paras(ParametersLoader), max_batch=8,
                             device="cpu"),
            jax_export.LiveModel(paras(JaxParams), max_batch=8))


def test_residual_scale_blend_matches_jax(blended):
    from rdst_tpu_torch.data import ops

    live, ref = blended
    assert live.manifest["residual_scale"] == 0.5
    x = np.random.default_rng(3).random((3,) + LR + (1,), dtype=np.float32)
    got, want = live.predict(x, 4.0), ref.predict(x, 4.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = export._bucketed_predict(live._run, x, live.buckets)
    bicubic = np.stack([ops.resize(xi, plain.shape[1:3]) for xi in x])
    np.testing.assert_allclose(got, 0.5 * plain + 0.5 * bicubic, rtol=0,
                               atol=1e-6)


def test_sr_volume_matches_jax(blended):
    from rdst_tpu.serving.volume import sr_volume as jax_sr_volume
    from rdst_tpu_torch.serving.volume import sr_volume

    live, ref = blended
    vol = 100 + 50 * np.random.default_rng(4).random((12, 9, 5),
                                                     dtype=np.float32)
    for axis in (2, 0):
        got = sr_volume(live, vol, 4.0, axis=axis)
        want = jax_sr_volume(ref, vol, 4.0, axis=axis)
        assert got.shape == want.shape
        # 1e-5 of the volume's range (50)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 50)
    with pytest.raises(ValueError, match="non-finite"):
        sr_volume(live, np.full((4, 4, 2), np.nan, np.float32), 4.0)


def test_volume_main_bundle_raises():
    from rdst_tpu_torch.serving.volume import main as volume_main

    with pytest.raises(FileNotFoundError,
                       match="MANIFEST.json.*rdst_tpu_torch.serving.export"):
        volume_main(["--bundle", "b", "--in", "x.nii", "--out", "y.nii"])
