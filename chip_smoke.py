"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's main paths -- the shipped RDST-E1 x4 config with its
committed weights, served over HTTP by ``rdst_tpu_torch.serving`` in
float32 and in bfloat16 (``inference_dtype='bfloat16'``) -- and holds
every CUDA kernel of those paths against its plain PyTorch version on the
card. Phases, each printed with its seconds:

1. the card (``nvidia-smi`` name and power limit);
2. build every kernel source with ``nvcc`` (one process per source, all
   started together), with each ptxas report of registers and spills;
3. the f32 block kernel vs its plain version at the main path's shapes
   (bucket 64: 64 slices x 20 windows), with CUDA-event times and the
   bound;
4. the f32 model on 8 seeded 40x32 LR slices: kernel path vs plain
   path, finite, and the launch count per forward;
5. f32 serving: an ``InferenceServer`` on 127.0.0.1, warmed over the
   bucket ladder, answers a 1-slice, an 8-slice and a burst of 8
   concurrent 1-slice requests (coalesced by the batcher), each equal to
   a direct ``predict``; then p50 latency and slices/s per bucket. Launch
   counts are set to 0 just before this phase and read just after it;
6. device time of one f32 bucket-64 forward by kernel group
   (torch.profiler) and the device's idle share;
7. the bf16 kernels vs their plain versions at bucket 64 with the
   flagship's own weights: the fast block at the six (C, shift) variants
   under 'clamp' (the flagship's resolved variant) and 'stable_bc', the
   pair at C = 60/90/120, the RDSTB on the flagship geometry; CUDA-event
   times of the launch alone, plain time, bound, max and mean relative
   error (bar 0.02);
8. the bf16 model in modes rdstb, pair and swin on 8 slices: launches per
   forward (8 / 24 / 48, counts set to 0 just before each and read just
   after), the kernel path vs the plain bf16 path, and vs the f32 kernel
   path (relative error and PSNR);
9. bf16 serving (mode rdstb, the default): as phase 5;
10. the profile of one warm bf16 bucket-64 forward, as phase 6;
11. the train-pair kernels (``kernels.pair_train``, forward and
    backward) vs their plain version and its ``torch.autograd`` gradient,
    with the flagship's weights at the training geometry (32 images of
    24x24, C = 60/90/120), with and without stochastic-depth factor
    columns, under 'clamp' and 'stable' (and 'stable_mm' once, at C =
    60): relative max error of the output, the input cotangent and every
    weight and bias gradient (bar 0.02); CUDA-event times, plain times
    (the plain backward alone, through a graph built once) and bounds;
12. the bf16 training step: the 20-phantom corpus made by the port's
    generator, then ``python -m rdst_tpu_torch.train`` (in process) on
    ``config_files/rdst_e1_100k_oasis20_x4.ini`` for 20 steps with a
    quick evaluation every 10: 24 forward and 24 backward train-pair
    launches per step (counts set to 0 just before the run, read just
    after), a finite loss at every step, parameters that moved, the
    snapshot and its sidecar, the snapshot served by ``LiveModel``, a
    resume from the checkpoint that goes on for 2 more steps; the
    first step's loss and gradients on the kernel route against the
    plain bf16 route (loss rtol 2e-2, gradients relative max < 0.08);
13. steps/s on the wall clock over 10 warm steps queued back to back,
    and the profile of one warm training step.

Any failed phase raises and the script exits non-zero. It needs a CUDA
card: without one it exits non-zero and prints no result. The last two
lines of standard output are the kernel table (JSON) and the device
line (JSON).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

CONFIG = "config_files/rdst_e1_40k_oasis20_x4.ini"
WEIGHTS = "weights/rdst_e1_40k_best_oasis20_x4.msgpack"
LR_HW = (40, 32)
SCALE = 4.0
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, dense bf16 on
# the tensor cores, HBM3 bandwidth
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# Kernel vs plain, f32 on both sides: they differ only in summation order
# (K <= 240 terms) on O(1) activations.
KERNEL_TOL = 1e-4
# Whole model, kernel path vs plain path: 48 blocks of the above plus the
# same cuDNN convolutions on both sides.
MODEL_TOL = 1e-4
# A served response vs a direct predict of the same slices: equal batch
# shapes agree exactly; other batch shapes may take other cuDNN algorithms.
SERVE_TOL = 1e-5
# bf16 kernels vs their plain versions, relative max error max|k - p| /
# max|p|: both round to bf16 at the same places, so a difference is a
# bf16 rounding that landed the other way after f32 sums in another order
# (and the approximate reciprocal); test_kernels.py's bar for the JAX
# kernels.
BF16_TOL = 0.02
# bf16 model vs the f32 model (test_kernels.py:394-397): relative max and
# mean error.
BF16_VS_F32_MAX, BF16_VS_F32_MEAN = 0.05, 0.005
# the training step (phase 12): the shipped bf16 training config, cut to
# 20 steps; kernel route vs plain bf16 route on one step
# (tests/test_pair_train.py:192,209)
TRAIN_CONFIG = "config_files/rdst_e1_100k_oasis20_x4.ini"
TRAIN_STEPS, TRAIN_CHECK = 20, 10
WALL_STEPS = 10
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 2e-2, 0.08
# A bf16 response vs a direct predict of the same slices (HR values about
# 0..1): equal batch shapes agree exactly; at another batch shape the f32
# convolutions may take another cuDNN algorithm, and a bf16 rounding that
# moves by one ulp there travels through the model.
SERVE_TOL_BF16 = BF16_TOL


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Decorator: run a phase, print its seconds, let failures raise."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"== phase {name}")
            out = fn(*a, **kw)
            log(f"== phase {name}: ok in {time.perf_counter() - t0:.3f} s")
            return out
        return run
    return wrap


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@phase("card")
def card_phase() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


@phase("build")
def build_phase() -> dict:
    from rdst_tpu_torch.kernels import _build

    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        libs = dict(zip(_build.SOURCES, ex.map(_build.build, _build.SOURCES)))
    for src, path in libs.items():
        log(f"built {src} -> {path.name}")
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return {k: str(v) for k, v in libs.items()}


def _block_work(block, c: int, windows: int):
    """Flops and bytes of one launch: 16C^2 + 4NC flops per token; the
    input and output rows, every weight and the bias, each once."""
    n = 64
    flops = windows * n * (16 * c * c + 4 * n * c)
    weights = sum(p.numel() for name, p in block.named_parameters()
                  if not name.endswith("relative_position_bias_table"))
    return flops, weights


@phase("kernel vs plain")
def kernel_phase(model) -> dict:
    from rdst_tpu_torch.kernels.swin_block import (fused_swin_block,
                                                   swin_block_reference)

    ws, nw, images, nh = 8, 20, 64, 6
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    rdstb = model.body[0]
    for j, c in enumerate((60, 90, 120)):
        for k, shift in enumerate((0, ws // 2)):
            block = rdstb.body[j].body.blocks[k]
            if (block.dim, block.shift_size) != (c, shift):
                raise AssertionError(f"block {j}/{k} is not C={c} shift={shift}")
            params, bias = block.kernel_inputs(LR_HW, ws, shift)
            x = torch.randn(images * nw, ws * ws, c, device="cuda",
                            generator=gen)
            kw = dict(num_heads=nh, windows_per_image=nw)
            with torch.inference_mode():
                want = swin_block_reference(x, *params, bias, **kw)
                got = fused_swin_block(x, *params, bias, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not (err <= KERNEL_TOL and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"fused_swin_block C={c} shift={shift}: max abs err "
                        f"{err} > {KERNEL_TOL}")
                ms = cuda_time_ms(lambda: fused_swin_block(x, *params, bias,
                                                           **kw))
                plain_ms = cuda_time_ms(
                    lambda: swin_block_reference(x, *params, bias, **kw))
            flops, weights = _block_work(block, c, images * nw)
            nbytes = 4 * (2 * x.numel() + weights + bias.numel())
            t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(c=c, shift=shift, windows=images * nw,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       flops=flops, bytes=nbytes,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
            log(f"fused_swin_block C={c:3d} shift={shift}: err {err:.3e} "
                f"(tol {KERNEL_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} "
                f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
            rows.append(row)
    log("library yardstick: no single PyTorch call computes a whole Swin "
        "block (LN, qkv, biased softmax attention, proj, LN, GELU MLP)")
    return {"variants": rows}


@phase("whole model")
def model_phase(live) -> dict:
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.nn.swin import set_block_kernels

    rng = np.random.default_rng(SEED)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    swin_block.fused_swin_block.launches = 0
    y_kernel = live.predict(x, SCALE)
    launches = swin_block.fused_swin_block.launches
    # the plain path of this same model: its own blocks' flag, set back
    # before it serves
    set_block_kernels(live.model, False)
    try:
        y_plain = live.predict(x, SCALE)
    finally:
        set_block_kernels(live.model, True)
    if swin_block.fused_swin_block.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    want_shape = (8, int(LR_HW[0] * SCALE), int(LR_HW[1] * SCALE), 1)
    err = float(np.abs(y_kernel - y_plain).max())
    log(f"8 slices {LR_HW} -> {y_kernel.shape}: kernel vs plain max abs err "
        f"{err:.3e} (tol {MODEL_TOL}); fused_swin_block launches per "
        f"forward {launches}")
    if y_kernel.shape != want_shape or not np.isfinite(y_kernel).all():
        raise AssertionError(f"bad output {y_kernel.shape}, finite="
                             f"{np.isfinite(y_kernel).all()}")
    if err > MODEL_TOL:
        raise AssertionError(f"kernel path vs plain path: {err} > {MODEL_TOL}")
    if launches != 48:
        raise AssertionError(f"{launches} block-kernel launches per forward, "
                             "expected 48 (8 RDSTBs x 3 DSTLs x 2 blocks)")
    return {"max_abs_err": err, "launches_per_forward": launches}


def _serve(live, counter=None, per_forward: int = 48,
           dtype: str = "float32", tol: float = SERVE_TOL) -> dict:
    """Serve ``live`` over HTTP; ``counter`` is the kernel wrapper whose
    ``launches`` the main path adds to (``per_forward`` a forward)."""
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer

    if counter is None:
        from rdst_tpu_torch.kernels.swin_block import fused_swin_block

        counter = fused_swin_block
    name = counter.__name__

    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=64,
                          batch_wait_ms=25.0)
    out = {}
    try:
        out["warmup_s"] = srv.warmup(lr_hw=LR_HW, scale=SCALE)
        log(f"warmed buckets {live.buckets} in {out['warmup_s']} s")
        srv.start_background()
        client = SRClient(f"http://127.0.0.1:{srv.port}")
        if client.health() != {"status": "ok"}:
            raise AssertionError("healthz")
        meta = client.metadata()
        if meta["pallas_kernels"] is None or meta["dtype"] != dtype:
            raise AssertionError(f"metadata {meta}")
        rng = np.random.default_rng(SEED + 1)
        x8 = rng.random((8,) + LR_HW, dtype=np.float32)
        # direct predictions first: the launch count below covers served
        # requests only
        direct_1 = live.predict(x8[:1], SCALE)
        direct_8 = live.predict(x8, SCALE)
        direct = [live.predict(x8[i:i + 1], SCALE) for i in range(8)]

        def check(name, got, want):
            err = float(np.abs(got - want).max())
            log(f"{name}: {got.shape} max abs err vs direct predict "
                f"{err:.3e} (tol {tol})")
            if got.shape != want.shape or err > tol:
                raise AssertionError(f"{name}: err {err}")
            return err

        counter.launches = 0  # main path starts here
        out["err_1"] = check("1-slice request", client.predict(x8[:1], SCALE),
                             direct_1)
        out["err_8"] = check("8-slice request", client.predict(x8, SCALE),
                             direct_8)
        before = counter.launches
        barrier = threading.Barrier(8)

        def one(i):
            barrier.wait()
            return client.predict(x8[i:i + 1], SCALE)

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            burst = list(ex.map(one, range(8)))
        forwards = (counter.launches - before) // per_forward
        out["err_burst"] = max(check(f"burst request {i}", burst[i], direct[i])
                               for i in range(8))
        log(f"8 concurrent 1-slice requests ran as {forwards} forward(s)")
        if not 1 <= forwards < 8:
            raise AssertionError("the batcher did not coalesce the burst")
        out["burst_forwards"] = forwards

        lat = {}
        for b in live.buckets:
            xb = rng.random((b,) + LR_HW, dtype=np.float32)
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                y = client.predict(xb, SCALE)
                ts.append(time.perf_counter() - t0)
                if not np.isfinite(y).all():
                    raise AssertionError(f"non-finite response at bucket {b}")
            p50 = float(np.median(ts))
            lat[b] = {"p50_s": p50, "slices_per_s": b / p50, "times_s": ts}
            log(f"bucket {b:2d}: p50 {p50 * 1e3:.2f} ms, "
                f"{b / p50:.1f} slices/s over HTTP")
        out["latency"] = lat
        out["launches"] = counter.launches  # main path ends
        log(f"{name} launches while serving: {out['launches']}")
        if out["launches"] == 0:
            raise AssertionError(f"serving never launched {name}")
    finally:
        srv.close()
    return out


serving_phase = phase("serving")(_serve)


def _profile(live, kernel: str = "swin_block_kernel") -> dict:
    """Device time of one warm bucket-64 forward by kernel group
    (torch.profiler / CUPTI), and the device's idle share of the
    forward's wall time (numpy in, numpy out); ``kernel`` names the
    port's kernels' group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.random.default_rng(SEED + 2).random((64,) + LR_HW,
                                               dtype=np.float32)
    live.predict(x, SCALE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        live.predict(x, SCALE)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    group = kernel.replace("_kernel", " kernel")
    groups = {group: 0.0, "convolution": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        # device kernels only: the CPU ops that launch them report the
        # same time again
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        name = e.key.lower()
        if kernel in name:
            groups[group] += t
        elif any(w in name for w in ("conv", "cudnn", "xmma", "implicit")):
            groups["convolution"] += t
        else:
            groups["other"] += t
        top.append((t, e.count, e.key[:90]))
    busy = sum(groups.values())
    out = {"wall_us": wall_us, "device_us": busy, "groups_us": groups,
           "top": sorted(top, reverse=True)[:10]}
    if busy == 0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return out
    out["idle_share"] = 1.0 - busy / wall_us
    log(f"bucket-64 forward under the profiler: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share {out['idle_share']:.3f}")
    for name, t in groups.items():
        log(f"  {name}: {t / 1e3:.3f} ms ({100 * t / busy:.1f} % of device time)")
    for t, count, key in out["top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:4d} {key}")
    return out


profile_phase = phase("profile")(_profile)


def _rel(got, want):
    """(max, mean) of |got - want| / max|want|, in float32."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max()
    return (d.max() / scale).item(), (d.mean() / scale).item(), \
        d.max().item()


def _bound(flops: float, nbytes: float):
    """(bound ms, 'operations' or 'bytes') at the bf16 tensor-core peak."""
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _block_flops(windows: int, c: int, n: int = 64) -> float:
    """The block's work, not the kernels' padded form: 16C^2 + 4NC flops
    per token (qkv 6C^2, scores and P*V 4NC, proj 2C^2, MLP 8C^2)."""
    return windows * n * (16 * c * c + 4 * n * c)


def _plan_bytes(plan) -> int:
    return sum(t.numel() * t.element_size() for t in plan.layout) + \
        plan.bias.numel() * plan.bias.element_size()


def _check(name, got, want):
    rel_max, rel_mean, abs_max = _rel(got, want)
    finite = bool(torch.isfinite(got.float()).all())
    if not (finite and rel_max <= BF16_TOL):
        raise AssertionError(f"{name}: relative max err {rel_max} > "
                             f"{BF16_TOL} (finite={finite})")
    return rel_max, rel_mean, abs_max


@phase("bf16 kernels vs plain")
def bf16_kernel_phase(model) -> dict:
    """Each bf16 kernel's launch alone (weights prepared once, as the
    model keeps them) against its plain version, at bucket 64 with the
    flagship's own weights from its first RDSTB."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    ws, nw, images, nh = 8, 20, 64, 6
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rdstb = model.body[0]
    out = {"block": [], "pair": [], "rdstb": []}
    for softmax in ("clamp", "stable_bc"):
        for j, c in enumerate((60, 90, 120)):
            for k, shift in enumerate((0, ws // 2)):
                blk = rdstb.body[j].body.blocks[k]
                plan = swin_block.plan_fast_block(
                    *blk.fast_kernel_inputs(LR_HW, ws, shift), num_heads=nh)
                x = torch.randn(images * nw, ws * ws, c, device="cuda",
                                generator=gen).to(torch.bfloat16)
                kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
                with torch.inference_mode():
                    got = swin_block.run_fast_block(x, plan, **kw)
                    want = swin_block.swin_block_fast_reference(
                        x, plan.params, plan.bias, num_heads=nh,
                        softmax=softmax)
                    torch.cuda.synchronize()
                    err = _check(f"fast block C={c} shift={shift} {softmax}",
                                 got, want)
                    ms = cuda_time_ms(lambda: swin_block.run_fast_block(
                        x, plan, **kw))
                    plain_ms = cuda_time_ms(
                        lambda: swin_block.swin_block_fast_reference(
                            x, plan.params, plan.bias, num_heads=nh,
                            softmax=softmax))
                flops = _block_flops(images * nw, c)
                bound_ms, by = _bound(flops, 2 * 2 * x.numel()
                                      + _plan_bytes(plan))
                row = dict(c=c, shift=shift, softmax=softmax, rel_max=err[0],
                           rel_mean=err[1], max_abs_err=err[2], ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
                out["block"].append(row)
                log(f"fast block C={c:3d} shift={shift} {softmax:9s}: rel "
                    f"max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}) "
                    f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                    f"{bound_ms:.4f} ms ({by}, {flops / ms / 1e9:.1f} TFLOP/s)")
    softmax = model.softmax
    for j, c in enumerate((60, 90, 120)):
        layer = rdstb.body[j].body
        a, b = layer.blocks
        plan_a = swin_block.plan_fast_block(
            *a.fast_kernel_inputs(LR_HW, ws, 0), num_heads=nh)
        plan_b = swin_block.plan_fast_block(
            *b.fast_kernel_inputs(LR_HW, ws, ws // 2), num_heads=nh)
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
                  softmax=softmax)
        with torch.inference_mode():
            got = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
            want = swin_pair.swin_pair_reference(
                x, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias,
                **kw)
            torch.cuda.synchronize()
            err = _check(f"pair C={c}", got, want)
            ms = cuda_time_ms(lambda: swin_pair.run_swin_pair(
                x, plan_a, plan_b, **kw))
            plain_ms = cuda_time_ms(lambda: swin_pair.swin_pair_reference(
                x, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias,
                **kw))
        flops = 2 * _block_flops(images * nw, c)
        bound_ms, by = _bound(flops, 2 * 2 * x.numel() + _plan_bytes(plan_a)
                              + _plan_bytes(plan_b))
        out["pair"].append(dict(c=c, rel_max=err[0], rel_mean=err[1],
                                max_abs_err=err[2], ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=by))
        log(f"pair C={c:3d} {softmax}: rel max {err[0]:.3e} mean "
            f"{err[1]:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({by}, {flops / ms / 1e9:.1f} TFLOP/s)")
    h, w = LR_HW
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(LR_HW, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm)
    x = torch.randn(images, h * w, 60, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax=softmax)
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, growth=plan.growth,
            adapter_prenorm=plan.prenorm, **kw)
        torch.cuda.synchronize()
        err = _check("rdstb", got, want)
        ms = cuda_time_ms(lambda: rdstb_block.run_rdstb(x, plan, **kw))
        plain_ms = cuda_time_ms(lambda: rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, growth=plan.growth,
            adapter_prenorm=plan.prenorm, **kw), warmup=1, iters=5)
    # blocks of the three DSTLs, plus the 3x3 conv from 150 to 60 channels
    flops = sum(2 * _block_flops(images * nw, c) for c in (60, 90, 120)) \
        + images * h * w * 2 * 9 * 150 * 60
    nbytes = 2 * 2 * x.numel() + sum(
        t.numel() * t.element_size() for t in plan.kernel_args)
    bound_ms, by = _bound(flops, nbytes)
    out["rdstb"].append(dict(rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=by, flops=flops))
    log(f"rdstb {softmax}: rel max {err[0]:.3e} mean {err[1]:.3e} kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by}, "
        f"{flops / ms / 1e9:.1f} TFLOP/s)")
    log("library yardstick: no single PyTorch call computes a Swin block, "
        "a DSTL pair or an RDSTB")
    return out


@phase("bf16 whole model")
def bf16_model_phase(live16, live32, live_cpu) -> dict:
    """The bf16 model in each kernel mode: launches per forward; the card
    against the same model and route on the CPU, where every kernel
    wrapper takes its plain version (bar BF16_TOL); against the plain
    bf16 modules (mode off, the XLA-style path with other roundings:
    reported) and against the f32 kernel path (relative error, PSNR)."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair
    from rdst_tpu_torch.models.rdst import set_kernel_mode

    rng = np.random.default_rng(SEED + 4)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    model = live16.model
    softmax = model.softmax
    y32 = live32.predict(x, SCALE)
    set_kernel_mode(model, "", softmax)
    try:
        y_off = live16.predict(x, SCALE)
    finally:
        set_kernel_mode(model, "rdstb", softmax)
    counters = {"rdstb": (rdstb_block.run_rdstb, 8),
                "pair": (swin_pair.run_swin_pair, 24),
                "swin": (swin_block.run_fast_block, 48)}
    out = {}

    def versus(y, ref):
        r = _rel(torch.from_numpy(y), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((y - ref) ** 2)))

    off = versus(y_off, y32)
    log(f"bf16 plain modules (mode off) vs f32 kernel path: rel max "
        f"{off[0]:.3e} mean {off[1]:.3e}, PSNR {off[2]:.2f} dB")
    if off[0] >= BF16_VS_F32_MAX or off[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"bf16 plain modules vs f32: {off}")
    out["off"] = {"vs_f32_rel_max": off[0], "vs_f32_rel_mean": off[1],
                  "psnr_vs_f32_db": off[2]}
    try:
        for mode, (counter, want_launches) in counters.items():
            set_kernel_mode(model, mode, softmax)
            set_kernel_mode(live_cpu.model, mode, softmax)
            y_cpu = live_cpu.predict(x, SCALE)  # the plain versions
            for c, _ in counters.values():
                c.launches = 0  # this mode's path starts here
            y = live16.predict(x, SCALE)
            launches = {c.__name__: c.launches for c, _ in counters.values()}
            if launches[counter.__name__] != want_launches or sum(
                    launches.values()) != want_launches:
                raise AssertionError(f"mode {mode}: launches {launches}, "
                                     f"expected {want_launches} of "
                                     f"{counter.__name__}")
            if not np.isfinite(y).all():
                raise AssertionError(f"mode {mode}: non-finite output")
            kp, ko, kf = versus(y, y_cpu), versus(y, y_off), versus(y, y32)
            log(f"bf16 mode {mode}: {want_launches} launches of "
                f"{counter.__name__} per forward; vs its plain versions (the "
                f"CPU run) rel max {kp[0]:.3e} (bar {BF16_TOL}); vs plain "
                f"modules rel max {ko[0]:.3e}; vs f32 kernel path rel max "
                f"{kf[0]:.3e} mean {kf[1]:.3e}, PSNR {kf[2]:.2f} dB")
            if kp[0] > BF16_TOL:
                raise AssertionError(f"mode {mode} vs plain versions: {kp}")
            if kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
                raise AssertionError(f"mode {mode} vs f32: {kf}")
            out[mode] = {"launches_per_forward": launches[counter.__name__],
                         "vs_plain_versions_rel_max": kp[0],
                         "vs_plain_modules_rel_max": ko[0],
                         "vs_f32_rel_max": kf[0], "vs_f32_rel_mean": kf[1],
                         "psnr_vs_f32_db": kf[2]}
    finally:
        set_kernel_mode(model, "rdstb", softmax)
    return out


bf16_serving_phase = phase("bf16 serving")(_serve)
bf16_profile_phase = phase("bf16 profile")(_profile)


def _pair_train_operands(model, c: int, gen):
    """Folded flagship weights of the first DSTL of width c at the
    training geometry, with random bf16 tokens and cotangents."""
    from rdst_tpu_torch.kernels.swin_block import fast_params, pack_bias_fast

    ws, nh, images, nw = 8, 6, 32, 9
    j = (60, 90, 120).index(c)
    a, b = model.body[0].body[j].body.blocks
    pa, ba = a.fast_kernel_inputs((24, 24), ws, 0)
    pb, bb = b.fast_kernel_inputs((24, 24), ws, ws // 2)
    with torch.no_grad():
        ops = [*fast_params(pa, c, nh), pack_bias_fast(ba, nh, 64),
               *fast_params(pb, c, nh), pack_bias_fast(bb, nh, 64)]
    x = torch.randn(images * nw, 64, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    dz = torch.randn(images * nw, 64, c, device="cuda",
                     generator=gen).to(torch.bfloat16)
    keep = 0.9
    cols = (torch.rand(images, 4, device="cuda", generator=gen) < keep)
    dpf = (cols.float() / keep).repeat_interleave(nw * 64, 0).contiguous()
    return [o.detach().contiguous() for o in ops], x, dz, dpf


def _pair_train_grads(fn, ops, x, dz, dpf, kw):
    """Output and gradients (input, then every operand) of fn."""
    from rdst_tpu_torch.kernels.swin_block import FastParams

    leaves = [t.detach().clone().requires_grad_(True) for t in [x] + ops]
    out = fn(leaves[0], FastParams(*leaves[1:9]), leaves[9],
             FastParams(*leaves[10:18]), leaves[18], dpf, **kw)
    out.backward(dz)
    return out.detach(), [t.grad for t in leaves]


@phase("train-pair kernels vs plain")
def train_kernel_phase(model) -> dict:
    """Forward and backward kernels against the plain version and its
    autograd gradient, at the training geometry of the flagship."""
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels.swin_block import (FastParams, kernel_layout,
                                                   softmax_code)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    names = (["x"] + [f"a.{f}" for f in FastParams._fields] + ["bias_a"]
             + [f"b.{f}" for f in FastParams._fields] + ["bias_b"])
    rows = []
    for c in (60, 90, 120):
        ops, x, dz, dpf0 = _pair_train_operands(model, c, gen)
        variants = [(s, d) for s in ("clamp", "stable") for d in (False, True)]
        if c == 60:  # the wrapper takes stable_mm too: hold it once
            variants.append(("stable_mm", False))
        for softmax, use_dpf in variants:
            dpf = dpf0 if use_dpf else None
            kw = dict(num_heads=6, x_size=(24, 24), window_size=8,
                      shift=4, softmax=softmax)
            got, g_got = _pair_train_grads(pt.run_pair_train, ops, x,
                                           dz, dpf, kw)
            want, g_want = _pair_train_grads(pt.pair_train_reference,
                                             ops, x, dz, dpf, kw)
            torch.cuda.synchronize()
            errs = {"out": _rel(got, want)}
            for nm, a, b in zip(names, g_got, g_want):
                errs[nm] = _rel(a, b)
            worst = max(errs, key=lambda k: errs[k][0])
            finite = all(bool(torch.isfinite(g.float()).all())
                         for g in g_got) and bool(
                             torch.isfinite(got.float()).all())
            log(f"train pair C={c:3d} {softmax:9s} dpf={use_dpf!s:5s}: "
                f"out rel max {errs['out'][0]:.3e}, dx "
                f"{errs['x'][0]:.3e}, worst {worst} "
                f"{errs[worst][0]:.3e} (bar {BF16_TOL})")
            if not finite or errs[worst][0] > BF16_TOL:
                raise AssertionError(f"train pair C={c} {softmax} "
                                     f"dpf={use_dpf}: {errs}")
            row = dict(c=c, softmax=softmax, dpf=use_dpf,
                       rel_max={k: v[0] for k, v in errs.items()},
                       out_abs_err=errs["out"][2],
                       grad_abs_err=max(v[2] for k, v in errs.items()
                                        if k != "out"))
            if softmax == "clamp" and not use_dpf:
                geom = ((24, 24), 8, 4, 6, softmax_code(softmax))
                pa, pb = FastParams(*ops[:8]), FastParams(*ops[9:17])
                ba, bb = ops[8], ops[17]
                # the launch alone: weights laid out once
                la, lb = kernel_layout(pa), kernel_layout(pb)
                fwd = (x, la, ba, lb, bb, None, geom, 2 * c)
                _, y = pt.launch_forward(*fwd)
                row["ms"] = cuda_time_ms(
                    lambda: pt.launch_forward(*fwd), iters=10)
                row["bwd_ms"] = cuda_time_ms(lambda: pt.launch_backward(
                    x, dz, y, pa, ba, pb, bb, None, geom), warmup=1,
                    iters=5)
                with torch.no_grad():
                    row["plain_ms"] = cuda_time_ms(
                        lambda: pt.pair_train_reference(
                            x, pa, ba, pb, bb, None, **kw))

                # the plain backward alone: autograd through the
                # plain version's graph, built once
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in [x] + ops]
                twin = pt.pair_train_reference(
                    leaves[0], FastParams(*leaves[1:9]), leaves[9],
                    FastParams(*leaves[10:18]), leaves[18], None, **kw)
                row["plain_bwd_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(twin, leaves, dz,
                                                retain_graph=True),
                    warmup=1, iters=5)
                del twin, leaves
                windows = x.shape[0]
                flops = 2 * _block_flops(windows, c)
                wbytes = sum(t.numel() * t.element_size() for t in ops)
                tok = x.numel() * 2
                # forward: x in, out and y (block a's output) written
                row["bound_ms"], row["bound_by"] = _bound(
                    flops, 3 * tok + wbytes)
                # backward: x, dz, y in, dx out, every gradient (f32)
                row["bwd_bound_ms"], row["bwd_bound_by"] = _bound(
                    2 * flops, 4 * tok + wbytes + 2 * wbytes)
                log(f"  C={c}: forward {row['ms']:.4f} ms (plain "
                    f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f}"
                    f" {row['bound_by']}), backward {row['bwd_ms']:.4f} "
                    f"ms (plain {row['plain_bwd_ms']:.4f}, bound "
                    f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
            rows.append(row)
    log("library yardstick: no single PyTorch call computes a DSTL pair or "
        "its gradient")
    return {"variants": rows}


def _train_argv(data_dir: str, out_dir: str, steps: int) -> list:
    return ["--config-file", TRAIN_CONFIG,
            f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
            f"epochs_in_total={{'WarmUP': {steps}}}",
            f"check_every={TRAIN_CHECK}", "quick_eva_num_samples=8",
            "eva_metrics='psnr ssim'", "verbose=False"]


def _grads_of(trainer, batch):
    """Loss and gradients of one step on trainer's model (no update)."""
    dev = trainer.device
    trainer.model.train()
    pred = trainer.model(torch.from_numpy(batch["in"]).to(dev)).float()
    total, _ = trainer.loss(pred, {"out": torch.from_numpy(
        batch["out"]).to(dev)}, "WarmUP")
    grads = torch.autograd.grad(total, trainer.params)
    return float(total.detach()), [g.float() for g in grads]


@phase("bf16 training step")
def train_phase(tmp: str) -> dict:
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.data import synthetic
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.models.rdst import set_train_mode
    from rdst_tpu_torch.serving.export import LiveModel
    from rdst_tpu_torch.config import ParametersLoader

    out = {}
    data_dir = os.path.join(tmp, "OASIS", "example20")
    t0 = time.perf_counter()
    synthetic.make_oasis_example(
        data_dir, patient_ids=tuple(f"OAS1_{i:04d}_MR1" for i in range(1, 21)))
    out["corpus_s"] = time.perf_counter() - t0
    log(f"generated the 20-phantom corpus in {out['corpus_s']:.3f} s")

    # the first step's loss and gradients, kernel route vs plain route,
    # from the run's own initial parameters (same seed) and first batch
    probe = build_trainer(_train_argv(data_dir, os.path.join(tmp, "probe"),
                                      1))
    probe.setup()
    # the run below starts from these parameters (same seed, same init)
    init = {k: v.clone() for k, v in probe.model.state_dict().items()}
    batch = probe.ds_train.sample(np.random.default_rng(17))
    if probe.model.train_mode != "pair":
        raise AssertionError(f"train route {probe.model.train_mode}")
    loss_k, g_k = _grads_of(probe, batch)
    set_train_mode(probe.model, "")
    loss_p, g_p = _grads_of(probe, batch)
    gmax = max(float(g.abs().max()) for g in g_p)
    rel = max(float((a - b).abs().max())
              / max(1e-5, float(b.abs().max()), 0.12 * gmax)
              for a, b in zip(g_k, g_p))
    out.update(first_loss_kernel=loss_k, first_loss_plain=loss_p,
               first_grad_rel_max=rel)
    log(f"first step: loss kernel route {loss_k:.6f} vs plain bf16 route "
        f"{loss_p:.6f} (rtol {TRAIN_LOSS_RTOL}); gradients rel max {rel:.4f}"
        f" (bar {TRAIN_GRAD_TOL})")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p) or \
            rel >= TRAIN_GRAD_TOL:
        raise AssertionError("kernel route vs plain route on the first step")
    del probe

    out_dir = os.path.join(tmp, "outputs")
    pt.launch_forward.launches = pt.launch_backward.launches = 0  # main path
    t0 = time.perf_counter()
    trainer = train_main(_train_argv(data_dir, out_dir, TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches
    out.update(forward_launches=fwd, backward_launches=bwd)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): train-pair launches forward {fwd}, backward {bwd}")
    if fwd != 24 * TRAIN_STEPS or bwd != 24 * TRAIN_STEPS:
        raise AssertionError(f"expected {24 * TRAIN_STEPS} forward and "
                             "backward launches (24 DSTL pairs a step)")
    losses = trainer.training_loss_records.get("WarmUP", [])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    costs = trainer.training_epoch_costs[1:]
    out["losses"] = losses
    out["host_steps_per_s"] = len(costs) / sum(costs)
    log(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"{out['host_steps_per_s']:.3f} steps/s of host time (the host "
        "queues steps without waiting for the card; steps 2..20, quick "
        "evaluations excluded)")
    final = trainer.model.state_dict()
    moved = sum(not torch.equal(init[k], final[k]) for k in init)
    trained = sum(p.numel() > 0 for p in trainer.params)
    out["tensors_moved"] = moved
    if moved != trained:
        raise AssertionError(f"{moved} of {trained} trained tensors moved")
    snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
    with open(os.path.splitext(snap)[0] + ".stats.json") as f:
        stats = json.load(f)
    log(f"snapshot {os.path.getsize(snap)} bytes, sidecar {stats}; "
        f"{moved} of {trained} trained tensors moved from the initial "
        "parameters")
    if "attn_logit_max" not in stats:
        raise AssertionError(f"sidecar {stats}")
    paras = ParametersLoader(TRAIN_CONFIG)
    paras.set("well_trained_single_scale_model_g", snap)
    live = LiveModel(paras, max_batch=1, device="cuda")
    lr = trainer.ds_valid.get_test_pair(0)[4.0]["in"]
    y = live.predict(lr, SCALE)
    if not np.isfinite(y).all() or y.shape[1:3] != (lr.shape[1] * 4,
                                                     lr.shape[2] * 4):
        raise AssertionError(f"served {y.shape}")
    log(f"the snapshot served by LiveModel: {lr.shape} -> {y.shape}")
    # resume: the same command with 2 more steps goes on from step 20
    resumed = train_main(_train_argv(data_dir, out_dir, TRAIN_STEPS + 2))
    with open(resumed.log_file) as f:
        resumed_log = f.read()
    if resumed.step != TRAIN_STEPS + 2 or (
            f"Resumed from checkpoint: state_id=0 epoch={TRAIN_STEPS}"
            not in resumed_log):
        raise AssertionError(f"resume: step {resumed.step}")
    log(f"resumed from the step-{TRAIN_STEPS} checkpoint to step "
        f"{resumed.step}")
    out["resumed_step"] = resumed.step
    out["trainer"] = trainer
    return out


@phase("training profile")
def train_profile_phase(trainer) -> dict:
    """Device time of one warm training step by kernel group, and the
    device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rdst_tpu_torch.runners.trainer import pin_batch

    batch = pin_batch(trainer.ds_train.sample(np.random.default_rng(SEED + 6)))
    trainer.train_step(batch, "WarmUP")
    torch.cuda.synchronize()
    # steps/s on the wall clock: WALL_STEPS steps queued back to back, as
    # the training loop queues them, then one wait for the card
    t0 = time.perf_counter()
    for _ in range(WALL_STEPS):
        trainer.train_step(batch, "WarmUP")
    torch.cuda.synchronize()
    steps_per_s = WALL_STEPS / (time.perf_counter() - t0)
    log(f"{steps_per_s:.3f} steps/s over {WALL_STEPS} warm steps (wall "
        "clock, one batch)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, "WarmUP")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"train-pair forward": 0.0, "train-pair backward": 0.0,
              "convolution": 0.0, "matmul (adapters, optimizer)": 0.0,
              "other (LayerNorms, casts, elementwise)": 0.0}
    top = []
    events = prof.key_averages()
    for e in events:
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        name = e.key.lower()
        if "pair_train_fwd" in name:
            groups["train-pair forward"] += t
        elif "pair_block_bwd" in name or "sum_parts" in name:
            groups["train-pair backward"] += t
        elif any(w in name for w in ("conv", "cudnn", "xmma", "implicit",
                                     "wgrad", "dgrad")):
            groups["convolution"] += t
        elif any(w in name for w in ("gemm", "sm90", "cutlass")):
            groups["matmul (adapters, optimizer)"] += t
        else:
            groups["other (LayerNorms, casts, elementwise)"] += t
        top.append((t, e.count, e.key[:90]))
    busy = sum(groups.values())
    cpu = sorted(((float(e.self_cpu_time_total), e.count, e.key[:60])
                  for e in events
                  if e.device_type == DeviceType.CPU), reverse=True)
    out = {"steps_per_s": steps_per_s, "wall_us": wall_us,
           "device_us": busy, "groups_us": groups,
           "top": sorted(top, reverse=True)[:12], "host_top": cpu[:12],
           "host_ops": sum(n for _, n, _ in cpu)}
    if busy == 0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return out
    out["idle_share"] = 1.0 - busy / wall_us
    log(f"one training step under the profiler: wall {wall_us / 1e3:.3f} ms,"
        f" device busy {busy / 1e3:.3f} ms, idle share "
        f"{out['idle_share']:.3f}")
    for name, t in groups.items():
        log(f"  {name}: {t / 1e3:.3f} ms ({100 * t / busy:.1f} % of device "
            "time)")
    for t, count, key in out["top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:4d} {key}")
    log(f"host: {out['host_ops']} profiled CPU ops; by self CPU time "
        "(the profiler's own overhead included):")
    for t, count, key in out["host_top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:5d} {key}")
    return out




def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import LiveModel

    t_start = time.perf_counter()
    card = card_phase()
    libs = build_phase()
    paras = ParametersLoader(CONFIG)
    paras.set("well_trained_single_scale_model_g", WEIGHTS)
    t0 = time.perf_counter()
    live = LiveModel(paras, max_batch=64, device="cuda")
    log(f"loaded {CONFIG} + {WEIGHTS} on {live.device} in "
        f"{time.perf_counter() - t0:.3f} s (kernel mode "
        f"{live.manifest['pallas_kernels']}, softmax "
        f"{live.manifest['pallas_softmax']})")
    kern = kernel_phase(live.model)
    whole = model_phase(live)
    serve = serving_phase(live)
    prof = profile_phase(live)

    from rdst_tpu_torch.kernels import rdstb_block

    paras16 = ParametersLoader(CONFIG)
    paras16.set("well_trained_single_scale_model_g", WEIGHTS)
    paras16.set("inference_dtype", "bfloat16")
    t0 = time.perf_counter()
    live16 = LiveModel(paras16, max_batch=64, device="cuda")
    log(f"loaded the bf16 model in {time.perf_counter() - t0:.3f} s (kernel "
        f"mode {live16.manifest['pallas_kernels']}, softmax "
        f"{live16.manifest['pallas_softmax']}, routes "
        f"{live16.manifest['routes']})")
    if (live16.manifest["pallas_kernels"], live16.manifest["pallas_softmax"],
            live16.manifest["dtype"]) != ("rdstb", "clamp", "bfloat16"):
        raise AssertionError(f"bf16 manifest {live16.manifest}")
    kern16 = bf16_kernel_phase(live16.model)
    live_cpu = LiveModel(paras16, max_batch=8, device="cpu")
    whole16 = bf16_model_phase(live16, live, live_cpu)
    serve16 = bf16_serving_phase(live16, rdstb_block.run_rdstb, 8,
                                 "bfloat16", SERVE_TOL_BF16)
    prof16 = bf16_profile_phase(live16, "rdstb_kernel")
    kern_train = train_kernel_phase(live16.model)
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(tmp)
        prof_train = train_profile_phase(train.pop("trainer"))

    rows = kern["variants"]
    k = len(rows)
    kernels = [{
        "name": "fused_swin_block",
        "route": "cuda",
        "source": "rdst_tpu_torch/csrc/swin_block.cu",
        "replaces": "rdst_tpu/kernels/swin_block.py:757",
        "launches": serve["launches"],
        # per launch, averaged over the six (C, shift) variants that each
        # run 8 times in one forward: the main path's own mix at bucket 64
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows) / k,
        "plain_ms": sum(r["plain_ms"] for r in rows) / k,
        "bound_ms": sum(r["bound_ms"] for r in rows) / k,
        "bound_by": ("operations" if sum(r["bound_by"] == "operations"
                                         for r in rows) * 2 >= k else "bytes"),
        "library_ms": None,
    }]

    def row(name, source, replaces, launches, rs):
        # per launch, averaged over the variants the main path runs
        n = len(rs)
        return {"name": name, "route": "cuda",
                "source": f"rdst_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs) / n,
                "plain_ms": sum(r["plain_ms"] for r in rs) / n,
                "bound_ms": sum(r["bound_ms"] for r in rs) / n,
                "bound_by": ("operations" if sum(
                    r["bound_by"] == "operations" for r in rs) * 2 >= n
                    else "bytes"),
                "library_ms": None}

    main_softmax = live16.model.softmax
    kernels += [
        row("fused_swin_block_fast", "swin_block_fast.cu",
            "rdst_tpu/kernels/swin_block.py:757",
            whole16["swin"]["launches_per_forward"],
            [r for r in kern16["block"] if r["softmax"] == main_softmax]),
        row("fused_swin_pair", "swin_pair.cu",
            "rdst_tpu/kernels/swin_block.py:1001",
            whole16["pair"]["launches_per_forward"], kern16["pair"]),
        row("fused_rdstb", "rdstb_block.cu",
            "rdst_tpu/kernels/rdstb_block.py:334", serve16["launches"],
            kern16["rdstb"]),
    ]
    # the train pair at the main path's (clamp, no factor columns)
    # variants, one row for the forward kernel and one for the backward
    timed = [r for r in kern_train["variants"] if "ms" in r]
    # (max_abs_err: the output for the forward, the largest absolute
    # error of any gradient for the backward; relative errors are logged)
    train_rows = {
        "forward": ("ms", "plain_ms", "bound_ms", "bound_by",
                    train["forward_launches"], "out_abs_err"),
        "backward": ("bwd_ms", "plain_bwd_ms", "bwd_bound_ms",
                     "bwd_bound_by", train["backward_launches"],
                     "grad_abs_err"),
    }
    for part, (ms, plain, bound, by, launches, err) in train_rows.items():
        kernels.append(row(
            f"fused_swin_pair_train ({part})", "pair_train.cu",
            "rdst_tpu/kernels/pair_train.py:293", launches,
            [dict(max_abs_err=max(v[err] for v in kern_train["variants"]),
                  ms=r[ms], plain_ms=r[plain], bound_ms=r[bound],
                  bound_by=r[by]) for r in timed]))
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "libs": libs, "kernel": kern,
               "model": whole, "serving": serve, "profile": prof,
               "bf16": {"manifest": live16.manifest, "kernel": kern16,
                        "model": whole16, "serving": serve16,
                        "profile": prof16},
               "train": {"kernel": kern_train, "step": train,
                         "profile": prof_train},
               "kernels": kernels,
               "total_s": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
