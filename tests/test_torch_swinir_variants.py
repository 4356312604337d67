"""SwinIR's other heads in the port against the JAX ``SwinIR`` on the CPU,
built from ``KEY=VALUE`` overrides of the SwinIR-std config at small
widths: the real-world x4 head ``sir_upsampler = 'nearest+conv'``, the
denoise / artifact-removal head ``sir_upsampler = ''`` (the input added
back, the output at the input's size) and the absolute position
embedding ``sir_ape``.

* f32 forwards on seeded weights within 1e-4 of max|y| of the JAX XLA
  forward, the weights carried both ways bit for bit;
* bf16 forwards, mode 'swin' with int8 qkv (the kernels' plain
  versions), within 0.02 of max|y| of the JAX model with its kernels in
  interpret mode;
* one f32 training step: the L1 loss's parameter gradients against
  ``jax.grad``;
* the entry points: ``LiveModel`` serves each head from a snapshot, the
  trainer takes a denoise step on its HR-size input
  (``lr_image_size_remain = True``: the sampler sets ``in`` to ``res``;
  the JAX sampler leaves ``in`` at LR, so the JAX trainer's loss fails
  on the shapes, as for ZSSR);
* the refusals: ``sir_ape`` at another token count (the JAX apply fails
  too), the denoise head served without ``lr_image_size_remain``,
  ``nearest+conv`` at x2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zoo_conv as zc
from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.kernels import clear_kernel_caches
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu_torch.checkpoint import msgpack_reader as mr
from rdst_tpu_torch.checkpoint.convert import export_swinir
from rdst_tpu_torch.checkpoint.msgpack_writer import (import_state_dict,
                                                      write_snapshot)
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.data import synthetic
from rdst_tpu_torch.data.readers import make_train_valid_datasets
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.routes import set_kernel_mode
from rdst_tpu_torch.serving.export import LiveModel

CONFIG = str(zc.REPO / "config_files" / "swinir_std_40k_oasis20_x4.ini")
TOL, BF16_TOL = 1e-4, 0.02
# a conv weight's gradient sums ~3,000 pixel products: float32 sums in
# another order differ by up to 1e-4 of the largest gradient
GRAD_TOL = 1e-3
SMALL = {"sir_embed_dim": 12, "sir_swintr_layers": [2],
         "sir_num_heads": [2], "sir_window_size": 4, "patch_size": 8,
         "sir_drop_path_rate": 0.0}
# variant: (overrides, input size: LR for x4, HR-size for denoise, the
# training patch for ape)
VARIANTS = {
    "nearest+conv": ({"sir_upsampler": "nearest+conv"}, (8, 12)),
    "denoise": ({"sir_upsampler": "", "lr_image_size_remain": True},
                (16, 20)),
    "ape": ({"sir_ape": True}, (8, 8)),
}


def _paras(cls, variant, **kw):
    p = cls(CONFIG)
    for k, v in {**SMALL, **VARIANTS[variant][0], **kw}.items():
        p.set(k, v)
    return p


def _setup(variant, dtype=torch.float32, seed=11):
    """(JAX f32 model, seeded params, port model holding them, input)."""
    jm = jax_build(_paras(JaxParams, variant))
    x = zc._inputs([VARIANTS[variant][1]])[0]
    params = zc._seeded(jm, x, [None], seed=seed)
    model = build_generator(_paras(ParametersLoader, variant), dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           export_swinir(params).items()})
    return jm, params, model.eval(), x


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_f32_matches_jax(monkeypatch, variant):
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    jm, params, model, x = _setup(variant)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    scale = 1 if variant == "denoise" else 4
    assert got.shape == want.shape == (
        2, x.shape[1] * scale, x.shape[2] * scale, 1)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    back = mr.flatten(import_state_dict(model.state_dict())["params"])
    flat = mr.flatten(jax.tree.map(np.asarray, params)["params"])
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_matches_jax_interpret(monkeypatch, variant):
    """bf16, mode 'swin', int8 qkv, softmax 'clamp': the JAX model with
    ``fused_swin_block`` in interpret mode against the port's plain
    versions; the ape table rounded to bf16 in the port, promoted to
    float32 in the JAX package."""
    _, params, model, x = _setup(variant, torch.bfloat16, seed=21)
    assert set_kernel_mode(model, "swin", "clamp", {"qkv"}) == \
        ["fused_swin_block"]
    jm = jax_build(_paras(JaxParams, variant), dtype=jnp.bfloat16)
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RDST_TPU_PALLAS", "swin")
    monkeypatch.setenv("RDST_TPU_PALLAS_QUANT", "qkv")
    monkeypatch.setenv("RDST_TPU_PALLAS_SOFTMAX", "clamp")
    clear_kernel_caches()
    want = np.asarray(jax.jit(jm.apply)(
        params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    clear_kernel_caches()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("variant", ["nearest+conv", "denoise"])
def test_train_step_gradients_match_jax(monkeypatch, variant):
    """The L1 loss's parameter gradients of one f32 step (the plain
    modules), each within GRAD_TOL of the largest, against ``jax.grad``."""
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    jm, params, model, x = _setup(variant)
    target = np.random.default_rng(9).random(
        jax.eval_shape(jm.apply, params, x).shape).astype(np.float32)

    def loss(p):
        return jnp.mean(jnp.abs(jm.apply(p, x) - target))

    jg = export_swinir(jax.tree.map(np.asarray,
                                    jax.jit(jax.grad(loss))(params)))
    model.train()
    out = model(torch.from_numpy(x))
    torch.mean(torch.abs(out - torch.from_numpy(target))).backward()
    grads = {n: q.grad for n, q in model.named_parameters()}
    assert grads.keys() == jg.keys()
    big = max(float(np.abs(v).max()) for v in jg.values())
    for n, g in jg.items():
        assert np.abs(grads[n].numpy() - g).max() <= GRAD_TOL * big, n


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serves_from_snapshot(tmp_path, variant):
    """``LiveModel`` (``device='cpu'``) serves each head from a snapshot
    the port writes, through the overrides: x4 for nearest+conv and ape,
    the input's size for denoise; its manifest's scale is the config's,
    as the JAX ``build_serving_model`` takes it."""
    _, _, model, x = _setup(variant)
    snap = str(tmp_path / "g.msgpack")
    write_snapshot(snap, model.state_dict())
    live = LiveModel(_paras(ParametersLoader, variant,
                            inference_dtype="float32",
                            well_trained_single_scale_model_g=snap),
                     max_batch=2, device="cpu")
    y = live.predict(x[..., 0], 4.0)
    with torch.inference_mode():
        want = model(torch.from_numpy(x)).numpy()
    assert live.manifest["scales"] == [4.0]
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-6)


def test_denoise_trains_on_hr_size_input(tmp_path):
    """The denoise head's sampler batch: ``lr_image_size_remain`` sets
    ``in`` to ``res`` (the interpolated LR at the HR size), which the head
    maps to the target's size; the port's L1 step on it is finite (the
    JAX sampler leaves ``in`` at LR, and a scale-1 output cannot meet the
    HR target)."""
    root = tmp_path / "OASIS" / "example"
    # slices under the HR patch, padded to it (32 x 32)
    synthetic.make_oasis_example(str(root), shape=(24, 28, 6))
    ids = [f"OAS1_000{i}_MR1" for i in range(1, 5)]
    p = _paras(ParametersLoader, "denoise", data_folder=str(root),
               multi_threads=1, margin_oasis=[4, 4],
               training_patient_ids_oasis=ids[:2],
               validation_patient_ids_oasis=ids[2:3],
               testing_patient_ids_oasis=ids[3:])
    ds, _ = make_train_valid_datasets(p)
    batch = ds.sample(np.random.default_rng(0))
    assert batch["in"].shape == batch["out"].shape
    _, _, model, _ = _setup("denoise")
    out = model.train()(torch.from_numpy(batch["in"]))
    loss = torch.mean(torch.abs(out - torch.from_numpy(batch["out"])))
    loss.backward()
    assert out.shape == batch["out"].shape and torch.isfinite(loss)
    from rdst_tpu.data.readers import make_train_valid_datasets as jax_data

    jds, _ = jax_data(_paras(JaxParams, "denoise", **{
        k: p.get(k) for k in ("data_folder", "multi_threads", "margin_oasis",
                              "training_patient_ids_oasis",
                              "validation_patient_ids_oasis",
                              "testing_patient_ids_oasis")}))
    jb = jds.sample(np.random.default_rng(0))
    jm = jax_build(_paras(JaxParams, "denoise"))
    y = jax.eval_shape(jm.init_with_output, jax.random.PRNGKey(0),
                       jnp.asarray(jb["in"]))[0]
    assert jb["in"].shape[1:3] == (8, 8) and y.shape != jb["out"].shape


def _raises_ape_other_size():
    _, params, model, _ = _setup("ape")
    with torch.inference_mode(), pytest.raises(
            ValueError, match="64 positions.*96 tokens"):
        model(torch.zeros(1, 8, 12, 1))
    jm = jax_build(_paras(JaxParams, "ape"))
    with pytest.raises(Exception):
        jax.eval_shape(jm.apply, params, jnp.zeros((1, 8, 12, 1)))


def _raises_denoise_served_without_key():
    p = _paras(ParametersLoader, "denoise", lr_image_size_remain=False,
               well_trained_single_scale_model_g="absent.msgpack")
    with pytest.raises(ValueError, match="lr_image_size_remain = True"):
        LiveModel(p, device="cpu")


def _raises_nearest_conv_x2():
    with pytest.raises(ValueError, match="x4 only"):
        build_generator(_paras(ParametersLoader, "nearest+conv",
                               sr_scale=2.0))
    jm = jax_build(_paras(JaxParams, "nearest+conv", sr_scale=2.0))
    with pytest.raises(AssertionError, match="x4"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 8, 8, 1)))


@pytest.mark.parametrize("check", [
    _raises_ape_other_size, _raises_denoise_served_without_key,
    _raises_nearest_conv_x2],
    ids=lambda f: f.__name__[len("_raises_"):])
def test_refusals(check):
    check()
