"""Data parallelism of the port (``rdst_tpu_torch.parallel``) on the CPU:
two gloo ranks against one rank and against the JAX package on a
``mesh_shape=[2]`` mesh of its virtual CPU devices.

* the mesh: ``make_mesh_from_paras`` gives the JAX shape dicts and
  raises where the JAX one raises (8 CPU devices, explicit list);
  ``shard_batch_padded`` pads as the JAX one; a ``model`` / ``seq`` axis
  larger than 1 is refused, naming its ROADMAP item, at every entry point;
* the step: a reduced RDST (2 RDSTBs, embed 12) trains 3 steps of
  ``python -m rdst_tpu_torch.train``'s own run on 2 ranks (one spawned
  world runs every case, ``parallel.probe``): the loss and the summed
  gradient of each step within rtol 1e-4 / atol 1e-5 of the one-rank
  run's and of the JAX trainer's step on ``mesh_shape=[2]``, the
  parameters after each step too (an entry whose one-rank gradient is
  below 1e-6 may differ by up to the learning rate: Adam
  normalises rounding noise there, ``test_torch_adversarial.py``), and
  the two ranks' parameters bitwise equal after every step; the same
  against one rank for the batch-coupled terms (the seg-UNet Dice, the
  RaGAN step with its BatchNorm discriminator, SwinIR's stochastic
  depth) and a batch that does not divide 2 (replicated, warned once);
* the evaluations: rank 0 alone writes, and the final evaluation's
  report equals the one-rank run's;
* the tester and ``LiveModel`` over a data axis of 2 CPU replicas give
  one device's outputs and the JAX tester's / ``LiveModel``'s on
  ``mesh_shape=[2]``; buckets round up to a multiple of 2.
"""

import os
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.losses.sr_loss import SRLoss as JaxLoss
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.parallel import make_mesh_from_paras as jax_mesh
from rdst_tpu.parallel import replicate_tree
from rdst_tpu.parallel import shard_batch as jax_shard_batch
from rdst_tpu.parallel import shard_batch_padded as jax_padded
from rdst_tpu.runners.trainer import SRTrainer as JaxTrainer
from rdst_tpu.utils.optim import make_optimizer
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.checkpoint.msgpack_writer import import_rdstsr
from rdst_tpu_torch.cli import build_trainer
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.parallel import (Mesh, make_mesh_from_paras, probe,
                                     shard_batch, shard_batch_padded)
from rdst_tpu_torch.parallel.launch import spawn
from test_torch_adversarial import _adam_moments

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
UNET = str(REPO / "weights" / "unet_tiny.pkl")
WEIGHTS = str(REPO / "weights" / "rdst_tiny2k_oasis_x4.msgpack")
LR = 2e-5
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [2, 2], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [1, 1],
         "patch_size": 8, "batch_size": 4, "quick_eva_num_samples": 3,
         "multi_threads": 1, "verbose": False, "learning_rate": LR,
         "lr_decay_type": "milestones 3000", "eva_metrics": "psnr ssim"}
SWINIR = {"feature_generator": "swinir", "sir_token_size": 1,
          "sir_embed_dim": 12, "sir_window_size": 4,
          "sir_swintr_layers": [2], "sir_num_heads": [2],
          "sir_hidden_ratio": 2.0, "sir_qkv_bias": True, "sir_qk_scale": None,
          "sir_drop_rate": 0.0, "sir_attn_drop_rate": 0.0,
          "sir_drop_path_rate": 0.1, "sir_layer_norm": True, "sir_ape": False,
          "sir_patch_norm": True, "sir_use_checkpoint": False,
          "sir_img_range": 1.0, "sir_upsampler": "pixelshuffle",
          "sir_res_connection": "1conv"}
# case: (overrides, --seg-loss, steps)
CASES = {
    "f32": ({}, False, 3),
    "seg": ({"training_states": ["UNet-F"],
             "loss_scalars": {"UNet-F": {"L1": 0.1, "UNet-F": 1}},
             "training_losses": ["L1", "UNet-F"],
             "unet_loss_layers": {"encoder-L1": [1]},
             "unet_loss_mode": "OASIS_lesion_only",
             "unet_native_ckpt": UNET}, True, 2),
    "gan": ({"training_states": ["GAN-FT"],
             "loss_scalars": {"GAN-FT": {"L1": 1.0, "GAN": 0.005}},
             "training_losses": ["L1", "GAN"], "gan_type": "RaGAN",
             "gan_k": 1, "gan_d_depth": 3, "gan_d_base_features": 8},
            False, 2),
    "droppath": (SWINIR, False, 2),
    "odd": ({"batch_size": 3}, False, 2),
}
RTOL, ATOL = 1e-4, 1e-5
NOISE = 1e-6  # a one-rank gradient entry below it is rounding noise


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "OASIS" / "example"
    synthetic.make_oasis_example(str(root), shape=(40, 48, 24))
    return root


def _over(case, corpus, out):
    over, _, steps = CASES[case]
    ts = over.get("training_states", ["WarmUP"])[0]
    return {**SMALL, **over, "data_folder": str(corpus),
            "output_dir": str(out), "epochs_in_total": {ts: steps},
            "check_every": steps}


def _argv(case, corpus, out):
    return (["--config-file", TINY, "--gpu-id", "-1"]
            + (["--seg-loss"] if CASES[case][1] else [])
            + [f"{k}={v!r}" for k, v in _over(case, corpus, out).items()])


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Every case on 2 ranks (one spawned world) and on one rank (this
    process): ``{case: (one, rank 0, rank 1)}``."""
    root = tmp_path_factory.mktemp("dp")
    two = [(_argv(c, corpus, root / "two" / c), str(root / "two" / c))
           for c in CASES]
    spawn(probe.record_runs, ["cpu", "cpu"], two)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        probe.record_runs([(_argv(c, corpus, root / "one" / c),
                            str(root / "one" / c)) for c in CASES])
    return {c: (probe.load(str(root / "one" / c)),
                probe.load(str(root / "two" / c), 0),
                probe.load(str(root / "two" / c), 1)) for c in CASES}


def _grads(rec, b1=0.9):
    """Each step's gradient from Adam's first moment after it."""
    mu = rec["mu"]
    prev = np.concatenate([np.zeros_like(mu[:1]), mu[:-1]])
    return (mu - b1 * prev) / (1 - b1)


def _held(got, one):
    """Loss, gradient and parameters of each step against the one-rank
    run's (an entry whose one-rank gradient was noise at some step within
    the learning rate)."""
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=RTOL, atol=ATOL)
    g1 = _grads(one)
    np.testing.assert_allclose(_grads(got), g1, rtol=RTOL, atol=ATOL)
    noise = np.cumsum(np.abs(g1) < NOISE, axis=0) > 0  # noise so far
    err = np.abs(got["params"] - one["params"])
    bar = ATOL + RTOL * np.abs(one["params"])
    assert (err <= np.where(noise, np.maximum(bar, LR), bar)).all(), \
        float(err.max())


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one(runs, case):
    one, r0, r1 = runs[case]
    steps = CASES[case][2]
    assert (int(r0["world"]), int(r1["world"]), int(r1["rank"])) == (2, 2, 1)
    assert int(one["world"]) == 1
    assert len(one["loss"]) == len(r0["loss"]) == steps
    assert one["ok"].all() and r0["ok"].all()
    # each rank ran the generator on its half; the odd batch whole
    half = 3 if case == "odd" else 2
    assert list(r0["rows"]) == list(r1["rows"]) == [half] * steps
    for key in ("loss", "params", "mu", "d_state"):
        np.testing.assert_array_equal(r0[key], r1[key])  # bitwise
    _held(r0, one)
    for a, b in zip(r0["report"], one["report"]):
        assert sorted(a) == sorted(b)
        for k in b:
            assert abs(a[k] - b[k]) <= RTOL * abs(b[k]) + ATOL, k
    if case == "gan":  # the discriminator ran on the whole batch
        np.testing.assert_allclose(r0["d_state"], one["d_state"],
                                   rtol=RTOL, atol=ATOL)


def test_rank0_alone_writes_and_scores(runs):
    one, r0, _ = runs["f32"]
    two_root, one_root = str(r0["output_root"]), str(one["output_root"])
    for name in ("WarmUP_final_eva.npy",):
        got = np.load(os.path.join(two_root, "final_results", name),
                      allow_pickle=True)
        want = np.load(os.path.join(one_root, "final_results", name),
                       allow_pickle=True)
        for k, v in want[0].items():
            np.testing.assert_allclose(got[0][k], v, rtol=1e-6, atol=1e-6)
    with open(os.path.join(two_root, "training_log.txt")) as f:
        log = f.read()
    assert log.count("Training complete") == 1
    assert "steps/s of host time by rank" in log and "world=2" in log
    with open(os.path.join(two_root, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 1


def test_cli_spawns_its_ranks(corpus, tmp_path):
    """``python -m rdst_tpu_torch.train ... mesh_shape=[2]`` outside a
    process group spawns its two ranks and returns once they are done:
    rank 0's log, snapshot and one final evaluation; the same command for
    one more step resumes both ranks from rank 0's checkpoint."""
    from rdst_tpu_torch.cli import train_main

    def argv(steps):
        over = {**_over("f32", corpus, tmp_path), "epochs_in_total":
                {"WarmUP": steps}, "check_every": 1, "mesh_shape": [2]}
        return ["--config-file", TINY, "--gpu-id", "-1"] + [
            f"{k}={v!r}" for k, v in over.items()]

    assert train_main(argv(1)) is None
    root = tmp_path / "RDST_TINY_OASIS_SRx4_None"
    log = (root / "training_log.txt").read_text()
    assert "rank=0, world=2" in log and log.count("Final evaluation") == 1
    assert (root / "models" / "WarmUP_model_g.msgpack").exists()
    assert train_main(argv(2)) is None
    log = (root / "training_log.txt").read_text()
    assert "Resumed from checkpoint: state_id=0 epoch=1" in log
    assert log.count("Final evaluation") == 2


def test_torchrun_joins_the_group(corpus, tmp_path):
    """``torchrun --nproc-per-node 2 -m rdst_tpu_torch.train ...``: each
    process joins the group torchrun's environment describes and trains
    as one rank of a data axis of 2 (no mesh key: one CPU rank a
    process)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    over = {**_over("f32", corpus, tmp_path), "epochs_in_total":
            {"WarmUP": 1}, "check_every": 1}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-port", str(port), "-m", "rdst_tpu_torch.train",
           "--config-file", TINY, "--gpu-id", "-1"] + [
        f"{k}={v!r}" for k, v in over.items()]
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True,
                          timeout=300, env={**os.environ, "OMP_NUM_THREADS":
                                            "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (tmp_path / "RDST_TINY_OASIS_SRx4_None" /
           "training_log.txt").read_text()
    assert "rank=0, world=2" in log and log.count("Training complete") == 1


def test_two_ranks_match_jax_mesh(corpus, tmp_path, runs):
    """The JAX trainer's compiled step on a ``mesh_shape=[2]`` mesh of the
    virtual CPU devices, from the same initial parameters and batches."""
    one, r0, _ = runs["f32"]
    over = _over("f32", corpus, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = build_trainer(_argv("f32", corpus, tmp_path))
    trainer.setup()
    model = trainer.model
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    rng = np.random.default_rng(17)  # the sampler's seed at step 0
    batches = [trainer.ds_train.sample(rng) for _ in range(3)]

    jp = JaxParams(TINY)
    for k, v in {**over, "mesh_shape": [2]}.items():
        jp.set(k, v)
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.model, jt.tx, jt.loss = jax_build(jp), make_optimizer(jp), JaxLoss(jp)
    jt.loss_threshold, jt.residual_scale = float(jp.loss_threshold), 0.0
    mesh = jax_mesh(jp)
    assert dict(mesh.shape) == {"data": 2}
    step = jt._make_train_step("WarmUP")
    params = replicate_tree(mesh, import_rdstsr(model.state_dict()))
    opt_state = replicate_tree(mesh, jt.tx.init(params))

    def flat(tree):
        sd = export_rdstsr(jax.tree.map(np.asarray, tree), model.mean,
                           model.std)
        return np.concatenate([np.asarray(sd[n], np.float32).reshape(-1)
                               for n in names])

    rec = {"loss": [], "params": [], "mu": []}
    for b in batches:
        db = jax_shard_batch(mesh, {"in": jnp.asarray(b["in"]),
                                    "out": jnp.asarray(b["out"])})
        assert db["in"].sharding.spec == jax.sharding.PartitionSpec("data")
        params, opt_state, total, _, ok = step(
            params, opt_state, db, jax.random.PRNGKey(3), 4.0)
        assert bool(ok)
        rec["loss"].append(float(total))
        rec["params"].append(flat(params))
        rec["mu"].append(flat(_adam_moments(opt_state).mu))
    jax_rec = {k: np.asarray(v) for k, v in rec.items()}
    assert jax_rec["params"].shape == one["params"].shape
    _held(r0, jax_rec)
    _held(one, jax_rec)


def _paras(**kw):
    p = ParametersLoader.from_dict({})
    for k, v in kw.items():
        p.set(k, v)
    return p


def test_mesh_from_paras_as_jax():
    cpus = ["cpu"] * 8
    cases = [({}, None), ({"mesh_shape": [2, 2, 2]}, None),
             ({"mesh_shape": [2, -1], "mesh_axes": ["data", "model"]}, None),
             ({"mesh_shape": [16, 1]}, ValueError),
             ({"mesh_shape": [-1, -1]}, ValueError),
             ({"mesh_shape": [2, 4], "mesh_axes": ["data"]}, ValueError),
             ({"mesh_shape": [1, 1, 1, 2]}, ValueError)]
    for keys, err in cases:
        jp = JaxParams.from_dict({})
        for k, v in keys.items():
            jp.set(k, v)
        if err is None:
            want = dict(jax_mesh(jp).shape)
            got = make_mesh_from_paras(_paras(**keys), devices=cpus)
            assert got.shape == want, keys
            assert len(got.devices) == int(np.prod(list(want.values())))
        else:
            with pytest.raises(err):
                jax_mesh(jp)
            with pytest.raises(err):
                make_mesh_from_paras(_paras(**keys), devices=cpus)
    # the CPU's ranks: as many as mesh_shape asks; one without it
    assert make_mesh_from_paras(_paras(mesh_shape=[3]), "cpu").size == 3
    assert make_mesh_from_paras(_paras(), "cpu").devices == [
        torch.device("cpu")]


def test_shard_batch_padded_as_jax():
    x = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    jmesh = jax_mesh(JaxParams.from_dict({"mesh_shape": [2]}))
    want, n_want = jax_padded(jmesh, x)
    mesh = make_mesh_from_paras(_paras(mesh_shape=[2]), "cpu")
    shards, n = shard_batch_padded(mesh, x)
    assert n == n_want == 7 and [s.shape[0] for s in shards] == [4, 4]
    np.testing.assert_array_equal(torch.cat(shards).numpy(),
                                  np.asarray(want))


def test_shard_batch_replicates_and_warns_once():
    mesh = Mesh(("data",), [2], ["cpu", "cpu"], rank=1, world=2,
                distributed=True)
    batch = {"in": np.zeros((4, 2, 2, 1)), "odd": np.zeros((3, 2, 2, 1)),
             "sr_factor": 4.0}
    with pytest.warns(UserWarning, match="does not divide") as seen:
        out = shard_batch(mesh, batch)
        shard_batch(mesh, batch)
    assert len(seen) == 1
    assert out["in"].shape[0] == 2 and out["odd"].shape[0] == 3
    assert out["sr_factor"] == 4.0


@pytest.mark.parametrize("shape", [[1, 2], [1, 1, 2]])
@pytest.mark.parametrize("entry", ["train", "test", "serve"])
def test_model_and_seq_axes_are_refused(corpus, tmp_path, shape, entry):
    """The repair: a mesh the port cannot run raises at build and names
    the ROADMAP item; before, every entry point ran on one device."""
    from rdst_tpu_torch.runners.tester import SRTester
    from rdst_tpu_torch.serving.export import LiveModel

    over = {**_over("f32", corpus, tmp_path), "mesh_shape": shape,
            "well_trained_single_scale_model_g": WEIGHTS}
    p = ParametersLoader(TINY)
    for k, v in over.items():
        p.set(k, v)
    axis = "model" if len(shape) == 2 else "seq"
    with pytest.raises(NotImplementedError,
                       match=f"'{axis}' of size 2.*ROADMAP Queue A 11"):
        if entry == "train":
            build_trainer(["--config-file", TINY, "--gpu-id", "-1"]
                          + [f"{k}={v!r}" for k, v in over.items()])
        elif entry == "test":
            SRTester(p, device="cpu")
        else:
            LiveModel(p, device="cpu")


@pytest.mark.parametrize("entry", ["seg_eval", "train_seg_unet",
                                   "train_vgg_features"])
def test_one_device_entry_points_refuse_a_data_axis(entry):
    """The segmentation evaluation and the auxiliary trainers run on one
    device (as their JAX counterparts do): a mesh key asking for more
    raises instead of being dropped."""
    import importlib

    fn = getattr(importlib.import_module(f"rdst_tpu_torch.runners.{entry}"),
                 entry)
    p = ParametersLoader(TINY)
    p.set("mesh_shape", [2])
    with pytest.raises(ValueError, match=f"{entry} runs on one device"):
        fn(p, *(["unused.pkl"] if entry == "seg_eval" else []),
           device="cpu")


# -- inference over the data axis -------------------------------------------


@pytest.fixture(scope="module")
def test_corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("tester") / "OASIS" / "example"
    synthetic.make_oasis_example(str(data), shape=(64, 80, 40))
    return data


def _tester_paras(cls, corpus, out, **kw):
    p = cls(TINY)
    for k, v in {"data_folder": str(corpus), "output_dir": str(out),
                 "well_trained_single_scale_model_g": WEIGHTS,
                 "verbose": False, **kw}.items():
        p.set(k, v)
    return p


def test_tester_over_two_replicas(test_corpus, tmp_path):
    from rdst_tpu.runners.tester import SRTester as JaxTester
    from rdst_tpu_torch.runners.tester import SRTester

    results = {}
    for label, kw in (("one", {}), ("two", {"mesh_shape": [2]})):
        t = SRTester(_tester_paras(ParametersLoader, test_corpus,
                                   tmp_path / label, **kw), device="cpu")
        assert t.mesh.size == kw.get("mesh_shape", [1])[0]
        t.setup()
        assert len(t.replicas) == t.mesh.size
        results[label] = (t, t.test())
    jt = JaxTester(_tester_paras(JaxParams, test_corpus, tmp_path / "jax",
                                 mesh_shape=[2]))
    assert dict(jt.mesh.shape) == {"data": 2}
    jt.setup()
    results["jax"] = (jt, jt.test())
    name = "OAS1_0004_MR1_inference_results.npz"
    vols = {k: np.load(os.path.join(t.dirs["inference_results"], name))
            ["x4.0"] for k, (t, _) in results.items()}
    assert vols["two"].shape == (25, 72, 56, 1)  # 25 slices: padded to 26
    np.testing.assert_allclose(vols["two"], vols["one"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(vols["two"], vols["jax"], rtol=0, atol=1e-4)
    two, one, jx = (results[k][1] for k in ("two", "one", "jax"))
    np.testing.assert_allclose(two["psnr_4.0"], one["psnr_4.0"], atol=1e-5)
    np.testing.assert_allclose(two["psnr_4.0"], jx["psnr_4.0"], atol=1e-3)
    np.testing.assert_allclose(two["ssim_4.0"], jx["ssim_4.0"], atol=1e-5)


def test_tiled_tester_over_two_replicas(test_corpus, tmp_path):
    """Tiled inference: the chunk rounds to a multiple of the axis."""
    from rdst_tpu_torch.runners.tester import SRTester

    outs = []
    for label, kw in (("one", {}), ("two", {"mesh_shape": [2]})):
        t = SRTester(_tester_paras(ParametersLoader, test_corpus,
                                   tmp_path / label, tiled_inference=True,
                                   test_lr_patch_stride=4, patch_size=8,
                                   batch_size=3, **kw), device="cpu")
        t.setup()
        sizes = []
        for m in t.replicas:
            m.register_forward_pre_hook(
                lambda mod, args: sizes.append(args[0].shape[0]))
        t.test()
        outs.append(np.load(os.path.join(
            t.dirs["inference_results"],
            "OAS1_0004_MR1_inference_results.npz"))["x4.0"])
        if kw:  # chunks of 12 (max(4 * 3, 8)), cut 6 + 6
            assert max(sizes) == 6 and len(sizes) % 2 == 0, sizes
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)


def test_live_model_over_two_replicas():
    from rdst_tpu.serving.export import LiveModel as JaxLive
    from rdst_tpu_torch.serving.export import LiveModel

    p = ParametersLoader(TINY)
    p.set("well_trained_single_scale_model_g", WEIGHTS)
    one = LiveModel(p, max_batch=8, device="cpu")
    two = LiveModel(p, max_batch=8, device="cpu", devices=["cpu", "cpu"])
    assert one.manifest["mesh"] == {"data": 1}
    assert two.manifest["mesh"] == {"data": 2}
    jp = JaxParams(TINY)
    jp.set("well_trained_single_scale_model_g", WEIGHTS)
    jp.set("mesh_shape", [2])
    jlive = JaxLive(jp, max_batch=8)
    assert jlive.manifest["mesh"] == two.manifest["mesh"]
    sizes = []
    for m in two.replicas:
        m.register_forward_pre_hook(
            lambda mod, args: sizes.append(args[0].shape[0]))
    rng = np.random.default_rng(0)
    for n, shard in ((1, 1), (3, 4), (8, 4)):
        x = rng.random((n, 16, 12), dtype=np.float32)
        sizes.clear()
        got = two.predict(x, 4.0)
        assert sizes == [shard, shard], (n, sizes)  # a bucket of 1 runs as 2
        np.testing.assert_allclose(got, one.predict(x, 4.0), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got, jlive.predict(x, 4.0), rtol=0,
                                   atol=1e-4)
