"""The port's training entry point end to end on the CPU
(``python -m rdst_tpu_torch.train ... --gpu-id -1``), at a reduced RDST on
a small synthetic corpus:

* a 2-step bf16 run through the pair route with a quick evaluation each
  step writes the snapshot, its sidecar (``attn_logit_max``) and the
  checkpoint; a second run resumes and its step count goes on;
* the guarded step decides on the device: a refused loss moves nothing;
* the snapshot loads with ``flax.serialization.from_bytes`` into the JAX
  model's tree and ``rdst_tpu``'s ``LiveModel`` serves it as the port's
  does (f32, 1e-4);
* the weights cross both ways: ``rdst_tpu`` params -> the port -> msgpack
  bytes -> flax, with the JAX forward matching the port's (1e-4);
* the entry point, and those of ``seg_eval`` and the two auxiliary
  trainers, run with jax, flax, optax, orbax, msgpack, cv2, tabulate,
  matplotlib and ``rdst_tpu`` unimportable, and refuse to run without a
  card unless ``--gpu-id -1`` asks for the CPU;
* the stall and RSS watchdogs (``rdst_tpu``'s ``test_stall_watchdog`` and
  ``test_rss_restart_guard``): the warning, the abort with ``os._exit``
  stubbed, and the RSS flag leading to a checkpoint and exit 17.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.serving import export as jax_export
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.checkpoint.msgpack_reader import msgpack_restore
from rdst_tpu_torch.checkpoint.msgpack_writer import import_rdstsr, to_bytes
from rdst_tpu_torch.cli import build_trainer, train_main
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.data.readers import make_test_dataset
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.serving import export

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [2, 2], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [1, 1],
         "patch_size": 8}
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "cv2",
           "tabulate", "matplotlib", "rdst_tpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "OASIS" / "example"
    synthetic.make_oasis_example(str(root), shape=(40, 48, 24))
    return root


def _argv(corpus, out, steps, **kw):
    over = {**SMALL, "data_folder": str(corpus), "output_dir": str(out),
            "batch_size": 8, "epochs_in_total": {"WarmUP": steps},
            "check_every": 1, "quick_eva_num_samples": 2,
            "multi_threads": 1, "training_dtype": "bfloat16",
            "pallas_softmax": "auto", "eva_metrics": "psnr ssim",
            "verbose": False, **kw}
    return (["--config-file", TINY, "--gpu-id", "-1"]
            + [f"{k}={v!r}" for k, v in over.items()])


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    first = train_main(_argv(corpus, out, 2))
    second = train_main(_argv(corpus, out, 4))
    return out, first, second


def test_run_writes_artifacts_and_resumes(trained):
    out, first, second = trained
    root = out / "RDST_TINY_OASIS_SRx4_None"
    assert first.step == 2 and second.step == 4
    assert first.model.train_mode == "pair" and first.model.softmax == "clamp"
    assert len(second.training_loss_records["WarmUP"]) == 4
    log = (root / "training_log.txt").read_text()
    assert "Resumed from checkpoint: state_id=0 epoch=2" in log
    assert log.count("Training complete") == 2
    stats = json.loads((root / "models" / "WarmUP_model_g.stats.json")
                       .read_text())
    assert stats["mean"] == [0.0] and "attn_logit_max" in stats
    recs = [json.loads(x) for x in
            (root / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for name in ("host_state.json", "state.pt"):
        assert (root / "checkpoint" / name).is_file()


def test_guarded_step_is_decided_on_the_device(corpus, tmp_path):
    """``train_step`` returns its guard as a tensor and applies the
    update only where it holds: a loss at or above ``loss_threshold``
    leaves every parameter and the optimizer's count as they were."""
    trainer = build_trainer(_argv(corpus, tmp_path, 1, loss_threshold=0.0))
    trainer.setup()
    before = [p.detach().clone() for p in trainer.params]
    batch = trainer.ds_train.sample(np.random.default_rng(0))
    total, report, ok = trainer.train_step(batch, "WarmUP")
    assert isinstance(ok, torch.Tensor) and ok.dtype == torch.bool
    assert not bool(ok) and float(total) > 0.0
    assert all(torch.equal(a, p) for a, p in zip(before, trainer.params))
    assert trainer.opt.count == 0
    trainer.loss_threshold = float("inf")
    _, _, ok = trainer.train_step(batch, "WarmUP")
    assert bool(ok) and trainer.opt.count == 1
    assert sum(not torch.equal(a, p)
               for a, p in zip(before, trainer.params)) > 0


def test_snapshot_loads_in_flax_and_jax_serves_it(trained):
    out, _, second = trained
    snap = out / "RDST_TINY_OASIS_SRx4_None" / "models" / \
        "WarmUP_model_g.msgpack"
    jp = JaxParams(TINY)
    tp = ParametersLoader(TINY)
    for p in (jp, tp):
        for k, v in SMALL.items():
            p.set(k, v)
        p.set("well_trained_single_scale_model_g", str(snap))
    x0 = jnp.zeros((1, 8, 8, 1), jnp.float32)
    template = jax.jit(jax_build(jp).init)(jax.random.PRNGKey(0), x0)
    restored = serialization.from_bytes(template, snap.read_bytes())
    got = export_rdstsr(jax.tree.map(np.asarray, restored))
    for k, v in second.model.state_dict().items():
        if not k.startswith(("sub_mean", "add_mean")):
            np.testing.assert_array_equal(got[k], v.numpy())
    jlive = jax_export.LiveModel(jp, max_batch=1)
    tlive = export.LiveModel(tp, max_batch=1, device="cpu")
    x = np.random.default_rng(0).random((1, 12, 16, 1), dtype=np.float32)
    want = np.asarray(jlive.predict(x, 4.0))
    assert float(np.abs(tlive.predict(x, 4.0) - want).max()) <= 1e-4


def test_weights_cross_both_ways():
    jp, tp = JaxParams(TINY), ParametersLoader(TINY)
    for p in (jp, tp):
        for k, v in SMALL.items():
            p.set(k, v)
    jm = jax_build(jp)
    x = np.random.default_rng(1).random((2, 12, 8, 1), dtype=np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    tm = build_generator(tp)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        export_rdstsr(jax.tree.map(np.asarray, params)).items()})
    data = to_bytes(import_rdstsr(tm.state_dict()))
    back = serialization.from_bytes(params, data)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's own reader reads the same tree
    assert sorted(msgpack_restore(data)["params"]) == \
        sorted(params["params"])
    want = np.asarray(jm.apply(back, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4


def test_entry_point_without_jax_and_without_a_card(corpus, tmp_path):
    """The training entry point, and the entry points of ``seg_eval`` and
    the two auxiliary trainers (one step each), with jax, flax, optax,
    tabulate, matplotlib and the rest of ``BLOCKED`` unimportable; each
    refuses to run without a card unless ``--gpu-id -1`` asks for the
    CPU."""
    argv = _argv(corpus, tmp_path / "iso", 1)
    # a config of the corpus for the entry points that take no overrides,
    # and an SR volume where the tester saves it
    cfg = tmp_path / "aux.ini"
    cfg.write_text("\n".join(
        f"data_folder = '{corpus}'" if ln.startswith("data_folder")
        else f"output_dir = '{tmp_path / 'aux'}'" if ln.startswith(
            "output_dir") else ln
        for ln in pathlib.Path(TINY).read_text().splitlines()))
    p = ParametersLoader(str(cfg))
    pid = p.testing_patient_ids_oasis[0]
    ds = make_test_dataset(p, [pid])
    sr = np.stack([ds.get_test_pair(i)[4.0]["gt"]
                   for i in range(ds.test_len())])
    inf = tmp_path / "aux" / "RDST_TINY_OASIS_SRx4_None_Final_Predictions" \
        / "inference_results"
    inf.mkdir(parents=True)
    np.savez(inf / f"{pid}_inference_results.npz", **{"x4.0": sr})
    unet, vgg = str(tmp_path / "unet.pkl"), str(tmp_path / "vgg.pkl")
    aux = [("rdst_tpu_torch.runners.train_seg_unet",
            ["--steps", "1", "--batch-size", "2", "--out", unet]),
           ("rdst_tpu_torch.runners.seg_eval", ["--unet", unet]),
           ("rdst_tpu_torch.runners.train_vgg_features",
            ["--steps", "1", "--batch-size", "2", "--patch", "32",
             "--out", vgg])]
    script = f"""
import importlib, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import torch
from rdst_tpu_torch.cli import build_trainer, train_main
argv = {argv!r}
if not torch.cuda.is_available():
    try:
        train_main([a for a in argv if a not in ("--gpu-id", "-1")])
    except RuntimeError as e:
        assert "cuda" in str(e), e
    else:
        raise AssertionError("trained on the CPU without --gpu-id -1")
t = train_main(argv)
assert t.step == 1
for mod, args in {aux!r}:
    main = importlib.import_module(mod).main
    args = ["--config-file", {str(cfg)!r}] + args
    if not torch.cuda.is_available():
        try:
            main(args)
        except RuntimeError as e:
            assert "cuda" in str(e), e
        else:
            raise AssertionError(mod + " ran on the CPU without --gpu-id -1")
    out = main(args + ["--gpu-id", "-1"])
    print(mod, "ran")
dice, _ = importlib.import_module(
    "rdst_tpu_torch.runners.seg_eval").main(
        ["--config-file", {str(cfg)!r}, "--unet", {unet!r}, "--gpu-id", "-1"])
assert dice.shape == (1, 4) and (dice >= 0).all(), dice
assert sorted(out) == ["losses", "params", "width"], sorted(out)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                and sys.modules[m] is not None)
print("LOADED", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    assert proc.stdout.count(" ran\n") == 3


def test_stall_watchdog(corpus, tmp_path, monkeypatch):
    """The stall watchdog (``rdst_tpu``'s ``test_stall_watchdog``): with no
    step completed it logs after ``stall_warn_s`` and exits 17 at
    ``stall_abort_s`` (``os._exit`` stubbed here); a run with the default
    thresholds trains to its end and logs nothing more."""
    import threading
    import time

    from rdst_tpu_torch.runners import trainer as trainer_mod

    trainer = build_trainer(_argv(corpus, tmp_path, 1, stall_warn_s=0.5,
                                  stall_abort_s=2.0))
    assert trainer.stall_warn_s == 0.5 and trainer.stall_abort_s == 2.0
    # setup runs under the watchdog too: the default thresholds for it,
    # the abort driven on _watchdog directly below
    trainer.stall_warn_s, trainer.stall_abort_s = 600.0, 0.0
    trainer.setup()
    exited = {}
    monkeypatch.setattr(trainer_mod.os, "_exit",
                        lambda code: exited.setdefault("code", code))
    stop = threading.Event()
    t = threading.Thread(target=trainer._watchdog, args=(stop, 0.5, 2.0))
    t.start()
    deadline = time.monotonic() + 30
    while "code" not in exited and time.monotonic() < deadline:
        time.sleep(0.1)
    stop.set()
    t.join(timeout=10)
    assert exited.get("code") == 17
    log = pathlib.Path(trainer.log_file).read_text()
    assert "WATCHDOG: no training progress" in log
    assert "WATCHDOG: aborting" in log
    trainer.train()
    log = pathlib.Path(trainer.log_file).read_text()
    assert log.count("WATCHDOG: aborting") == 1  # only the frozen probe's
    assert trainer.step == 1 and trainer._wd_step == 1


def test_rss_restart_guard(corpus, tmp_path, monkeypatch):
    """``rss_restart_gb`` (``rdst_tpu``'s ``test_rss_restart_guard``): the
    watchdog flags a host RSS above it and the step loop checkpoints and
    exits 17 at the next step boundary, so a restart resumes."""
    from rdst_tpu_torch.runners import trainer as trainer_mod

    trainer = build_trainer(_argv(corpus, tmp_path, 400, stall_warn_s=0.2,
                                  rss_restart_gb=0.001, check_every=1000))
    assert trainer.rss_restart_gb == 0.001
    assert trainer._rss_gb() > 0.001  # /proc backs it on Linux
    monkeypatch.setattr(trainer_mod.os, "_exit",
                        lambda code: (_ for _ in ()).throw(SystemExit(code)))
    trainer.setup()
    with pytest.raises(SystemExit) as e:
        trainer.train()
    assert e.value.code == 17
    assert 0 < trainer.step < 400
    log = pathlib.Path(trainer.log_file).read_text()
    assert "WATCHDOG: host RSS" in log
    assert f"RSS restart: checkpoint saved at step {trainer.step}" in log
    host = json.loads((pathlib.Path(trainer.checkpoint_dir)
                       / "host_state.json").read_text())
    assert host["step"] == host["current_epoch"] == trainer.step
