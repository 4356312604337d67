"""One training step of the port against ``rdst_tpu``'s on the CPU, at a
reduced RDST (2 RDSTBs, embed 12, growth 6, 2 heads, window 4; LR 8x8,
batch 4) from the same parameters and batch:

* float32 (plain autograd on both sides): the L1 loss and every gradient
  within 1e-4 relative, the parameters after one Adam step within 1e-6;
* bfloat16 through the pair route (the port's train-pair plain version
  vs the JAX kernel in interpret mode): loss within 2e-2, gradients
  relative max < 0.08 (``tests/test_pair_train.py``'s bars); the
  convolutions' bias gradients, which flax sums in bf16, against the
  JAX f32 step;
* the optimizers and LR schedules against optax;
* ``swin_drop_path_rate`` never reaches RDST's blocks, in the JAX package
  and in the port alike;
* after an optimizer step the serving routes refold their plans: the
  eval output equals that of a model built fresh with the new weights.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdst_tpu.config import ParametersLoader as JaxParams
from rdst_tpu.losses.sr_loss import SRLoss as JaxLoss
from rdst_tpu.models import build_generator as jax_build
from rdst_tpu.utils.optim import make_optimizer as jax_optimizer
from rdst_tpu_torch.checkpoint.convert import export_rdstsr
from rdst_tpu_torch.config import ParametersLoader
from rdst_tpu_torch.losses.sr_loss import SRLoss
from rdst_tpu_torch.models import build_generator
from rdst_tpu_torch.models.rdst import set_train_mode
from rdst_tpu_torch.utils.optim import Optimizer, make_schedule

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = str(REPO / "config_files" / "rdst_tiny_oasis_x4.ini")
SMALL = {"rdst_embed_dim": 12, "rdst_growth_rate": 6,
         "rdst_num_heads": [2, 2], "rdst_window_size": [4, 4],
         "rdst_dense_layer_depths": [2, 2], "rdst_rdb_depths": [2, 2],
         "patch_size": 8}


def _paras(cls, **kw):
    p = cls(TINY)
    for k, v in {**SMALL, **kw}.items():
        p.set(k, v)
    return p


def _setup(dtype, seed=0, **kw):
    """(JAX model, params, port model with the same weights, batch)."""
    jp, tp = _paras(JaxParams, **kw), _paras(ParametersLoader, **kw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = jax_build(jp, dtype=jdt)
    rng = np.random.default_rng(seed)
    x = rng.random((4, 8, 8, 1), dtype=np.float32)
    y = rng.random((4, 32, 32, 1), dtype=np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params)
    tm = build_generator(tp, dtype=dtype)
    sd = export_rdstsr(params, tm.mean, tm.std)
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()})
    return jp, tp, jm, params, tm, {"in": x, "out": y}


def _jax_step(jp, jm, params, batch):
    loss = JaxLoss(jp)

    def f(p):
        pred = jm.apply(p, jnp.asarray(batch["in"]), 4.0,
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "droppath": jax.random.PRNGKey(2)})
        return loss(pred.astype(jnp.float32),
                    {"out": jnp.asarray(batch["out"])}, "WarmUP")[0]

    v, g = jax.value_and_grad(f)(params)
    return float(v), jax.tree.map(np.asarray, g)


def _torch_step(tp, tm, batch):
    tm.train()
    params = [p for p in tm.parameters() if p.requires_grad]
    pred = tm(torch.from_numpy(batch["in"])).float()
    total, _ = SRLoss(tp)(pred, {"out": torch.from_numpy(batch["out"])},
                          "WarmUP")
    grads = torch.autograd.grad(total, params)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    return float(total.detach()), dict(zip(names, grads)), params


def _grad_pairs(jgrads, tgrads, tm):
    want = export_rdstsr(jgrads, tm.mean, tm.std)
    return [(tgrads[k].float().numpy(), np.asarray(want[k], np.float32))
            for k in tgrads]


def test_f32_step_matches_jax():
    jp, tp, jm, params, tm, batch = _setup(torch.float32)
    v_j, g_j = _jax_step(jp, jm, params, batch)
    v_t, g_t, tparams = _torch_step(tp, tm, batch)
    assert abs(v_t - v_j) <= 1e-4 * abs(v_j)
    pairs = _grad_pairs(g_j, g_t, tm)
    assert len(pairs) == len(jax.tree_util.tree_leaves(g_j))
    for got, want in pairs:
        assert float(np.abs(got - want).max()) <= 1e-4 * max(
            float(np.abs(want).max()), 1e-30)
    # one Adam step on both sides from the same gradients
    tx = jax_optimizer(jp)
    upd, _ = tx.update(g_j, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    opt = Optimizer(tparams, tp)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    want = export_rdstsr(jax.tree.map(np.asarray, g_j), tm.mean, tm.std)
    opt.step([torch.from_numpy(np.array(want[n])) for n in names])
    new_sd = export_rdstsr(jax.tree.map(np.asarray, new), tm.mean, tm.std)
    for n, p in zip(names, tparams):
        assert float(np.abs(p.detach().numpy() - new_sd[n]).max()) <= 1e-6


def test_bf16_pair_step_matches_jax_kernel(monkeypatch):
    jp, tp, jm, params, tm, batch = _setup(torch.bfloat16)
    assert set_train_mode(tm, "pair") == "pair"
    monkeypatch.setenv("RDST_TPU_PALLAS", "0")
    monkeypatch.setenv("RDST_TPU_PALLAS_TRAIN", "pair")
    monkeypatch.setenv("RDST_TPU_PALLAS_INTERPRET", "1")
    import rdst_tpu.kernels.pair_train as jpt

    calls = {"n": 0}
    orig = jpt.fused_swin_pair_train

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(jpt, "fused_swin_pair_train", spy)
    v_j, g_j = _jax_step(jp, jm, params, batch)
    assert calls["n"] == 4  # 2 RDSTBs x 2 DSTLs: the JAX kernel engaged
    from rdst_tpu_torch.kernels import pair_train as tpt

    seen = {"n": 0}
    torig = tpt.fused_swin_pair_train

    def tspy(*a, **k):
        seen["n"] += 1
        return torig(*a, **k)

    monkeypatch.setattr(tpt, "fused_swin_pair_train", tspy)
    v_t, g_t, _ = _torch_step(tp, tm, batch)
    assert seen["n"] == 4
    assert abs(v_t - v_j) <= 2e-2 * abs(v_j)
    # The convolutions' bias gradients are sums over every pixel. flax
    # reduces them in bf16, where the sum stalls once its ulp exceeds the
    # terms (tail.1.bias: 0.0625 against 0.914 over 4096 pixels); the
    # port sums in f32. Those leaves are held against the JAX f32 step.
    jp32, _, jm32, p32, _, _ = _setup(torch.float32)
    _, g32 = _jax_step(jp32, jm32, p32, batch)
    want32 = export_rdstsr(g32, tm.mean, tm.std)
    want = export_rdstsr(g_j, tm.mean, tm.std)
    conv_bias = [k for k in g_t if k.endswith(".bias") and (
        k.startswith(("head.", "tail.", "conv_after_body."))
        or ".conv." in k)]
    assert len(conv_bias) == 7
    ref = {k: np.asarray(want32[k] if k in conv_bias else want[k],
                         np.float32) for k in g_t}
    gmax = max(float(np.abs(w).max()) for w in ref.values())
    for k, got in g_t.items():
        denom = max(1e-5, float(np.abs(ref[k]).max()), 0.12 * gmax)
        err = float(np.abs(got.float().numpy() - ref[k]).max()) / denom
        assert err < 0.08, (k, err)


@pytest.mark.parametrize("decay", ["milestones 3 5 8", "step 4", ""])
def test_schedule_matches_optax(decay):
    from rdst_tpu.utils.optim import make_schedule as jax_schedule

    p = ParametersLoader(TINY)
    p.set("lr_decay_type", decay)
    p.set("lr_decay_gamma", 0.5)
    j = JaxParams(TINY)
    j.set("lr_decay_type", decay)
    j.set("lr_decay_gamma", 0.5)
    got, want = make_schedule(p), jax_schedule(j)
    for count in range(12):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-7)


@pytest.mark.parametrize("opt,wd", [("Adam", 0.0), ("Adam", 1e-2),
                                    ("SGD", 0.0), ("RMSprop", 1e-3)])
def test_optimizer_matches_optax(opt, wd):
    p, j = ParametersLoader(TINY), JaxParams(TINY)
    for cfg in (p, j):
        cfg.set("opt", opt)
        cfg.set("weight_decay", wd)
        cfg.set("lr_decay_type", "milestones 2 4")
    rng = np.random.default_rng(3)
    w0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(7,)).astype(np.float32)]
    tx = jax_optimizer(j)
    jw = [jnp.asarray(w) for w in w0]
    state = tx.init(jw)
    tw = [torch.from_numpy(w.copy()) for w in w0]
    o = Optimizer(tw, p)
    for _ in range(6):
        g = [rng.normal(size=w.shape).astype(np.float32) for w in w0]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jw)
        jw = optax.apply_updates(jw, upd)
        o.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    assert o.count == 6


@pytest.mark.parametrize("opt", ["Adam", "SGD", "RMSprop"])
def test_guarded_optimizer_step_matches_optax_skipping(opt):
    """A step refused on the device (``ok`` false, here with non-finite
    gradients) changes no parameter, no moment and not the count, as the
    JAX trainer's ``lax.cond`` skips ``tx.update``; the accepted steps
    match optax run on those steps alone."""
    p, j = ParametersLoader(TINY), JaxParams(TINY)
    for cfg in (p, j):
        cfg.set("opt", opt)
        cfg.set("momentum", 0.5)
        cfg.set("lr_decay_type", "milestones 2 3")
    rng = np.random.default_rng(5)
    w0 = [rng.normal(size=(4, 3)).astype(np.float32),
          rng.normal(size=(6,)).astype(np.float32)]
    tx = jax_optimizer(j)
    jw = [jnp.asarray(w) for w in w0]
    state = tx.init(jw)
    tw = [torch.from_numpy(w.copy()) for w in w0]
    o = Optimizer(tw, p)
    for keep in (True, False, True, True, False, True):
        g = [rng.normal(size=w.shape).astype(np.float32) for w in w0]
        if keep:
            upd, state = tx.update([jnp.asarray(x) for x in g], state, jw)
            jw = optax.apply_updates(jw, upd)
        else:
            g[1][2] = np.inf
            before = ([t.clone() for t in tw],
                      {k: v.clone() for k, v in o.state.items()})
        o.step([torch.from_numpy(x) for x in g], torch.tensor(keep))
        if not keep:
            assert all(torch.equal(a, b) for a, b in zip(before[0], tw))
            assert all(torch.equal(before[1][k], o.state[k])
                       for k in o.state)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    assert o.count == 4


def test_rdst_drop_path_rate_does_not_reach_the_blocks():
    """``RDSTSR`` passes no drop_path to its RDSTBs in the JAX package
    (rdst_tpu/models/rdst.py:410-428): training outputs do not depend on
    the droppath draws even at rate 0.5. The port keeps that function."""
    jp, tp, jm, params, tm, batch = _setup(torch.float32,
                                           swin_drop_path_rate=0.5)
    x = jnp.asarray(batch["in"])
    outs = [np.asarray(jm.apply(params, x, 4.0, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0),
                                      "droppath": jax.random.PRNGKey(s)}))
            for s in (1, 2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert all(r == 0.0 for m in tm.modules() if hasattr(m, "drop_path")
               and isinstance(m.drop_path, tuple) for r in m.drop_path)
    tm.train()
    with torch.no_grad():
        a = tm(torch.from_numpy(batch["in"]))
        b = tm(torch.from_numpy(batch["in"]))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(np.abs(a.numpy() - outs[0]).max()) <= 1e-4


def test_training_after_serving_in_one_process():
    """Serving under ``torch.inference_mode`` first fills the model
    builder's cached index and mask tensors; a training step afterwards
    must still differentiate through them (they are made outside
    inference mode)."""
    from rdst_tpu_torch.nn import swin

    swin._index_tensor.cache_clear()
    swin._mask_tensor.cache_clear()
    _, tp, _, _, tm, batch = _setup(torch.bfloat16)
    with torch.inference_mode():
        tm(torch.from_numpy(batch["in"]))
    set_train_mode(tm, "pair")
    loss, grads, _ = _torch_step(tp, tm, batch)
    assert np.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_eval_after_a_step_uses_the_new_weights():
    """The serving routes keep folded-weight plans keyed by the weights'
    versions: after an optimizer step the bf16 RDSTB route must serve the
    new weights, exactly as a model built with them does."""
    _, tp, _, _, tm, batch = _setup(torch.bfloat16)
    assert tm.routes == ["fused_rdstb"] * 2
    x = torch.from_numpy(batch["in"])
    tm.eval()
    with torch.no_grad():
        before = tm(x)  # builds the plans
    _, grads, params = _torch_step(tp, tm, batch)
    Optimizer(params, tp).step(list(grads.values()))
    tm.eval()
    with torch.no_grad():
        after = tm(x)
    fresh = build_generator(tp, dtype=torch.bfloat16)
    fresh.load_state_dict(tm.state_dict())
    with torch.no_grad():
        want = fresh(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)
