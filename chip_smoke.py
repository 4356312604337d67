"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's main path -- the shipped RDST-E1 x4 config with its
committed weights, served in float32 over HTTP by
``rdst_tpu_torch.serving`` -- and holds every CUDA kernel of that path
against its plain PyTorch version on the card. Phases, each printed with
its seconds:

1. the card (``nvidia-smi`` name and power limit);
2. build every kernel source with ``nvcc`` (one process per source);
3. each kernel vs its plain version at the main path's shapes (bucket
   64: 64 slices x 20 windows), with CUDA-event times and the bound;
4. the whole model on 8 seeded 40x32 LR slices: kernel path vs plain
   path, finite, and the launch count per forward;
5. serving: an ``InferenceServer`` on 127.0.0.1, warmed over the bucket
   ladder, answers a 1-slice, an 8-slice and a burst of 8 concurrent
   1-slice requests (coalesced by the batcher), each equal to a direct
   ``predict``; then p50 latency and slices/s per bucket. Launch counts
   are set to 0 just before this phase and read just after it;
6. device time of one bucket-64 forward by kernel group (torch.profiler)
   and the device's idle share.

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
import threading
import time

import numpy as np
import torch

CONFIG = "config_files/rdst_e1_40k_oasis20_x4.ini"
WEIGHTS = "weights/rdst_e1_40k_best_oasis20_x4.msgpack"
LR_HW = (40, 32)
SCALE = 4.0
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3 bandwidth
F32_FLOPS = 67e12
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


@phase("serving")
def serving_phase(live) -> dict:
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer

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
        if meta["pallas_kernels"] is None or meta["dtype"] != "float32":
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
                f"{err:.3e} (tol {SERVE_TOL})")
            if got.shape != want.shape or err > SERVE_TOL:
                raise AssertionError(f"{name}: err {err}")
            return err

        swin_block.fused_swin_block.launches = 0  # main path starts here
        out["err_1"] = check("1-slice request", client.predict(x8[:1], SCALE),
                             direct_1)
        out["err_8"] = check("8-slice request", client.predict(x8, SCALE),
                             direct_8)
        before = swin_block.fused_swin_block.launches
        barrier = threading.Barrier(8)

        def one(i):
            barrier.wait()
            return client.predict(x8[i:i + 1], SCALE)

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            burst = list(ex.map(one, range(8)))
        forwards = (swin_block.fused_swin_block.launches - before) // 48
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
        out["launches"] = swin_block.fused_swin_block.launches  # main path ends
        log(f"fused_swin_block launches while serving: {out['launches']}")
        if out["launches"] == 0:
            raise AssertionError("serving never launched fused_swin_block")
    finally:
        srv.close()
    return out


@phase("profile")
def profile_phase(live) -> dict:
    """Device time of one warm bucket-64 forward by kernel group
    (torch.profiler / CUPTI), and the device's idle share of the
    forward's wall time (numpy in, numpy out)."""
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
    groups = {"swin_block kernel": 0.0, "convolution": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        # device kernels only: the CPU ops that launch them report the
        # same time again
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        name = e.key.lower()
        if "swin_block_kernel" in name:
            groups["swin_block kernel"] += t
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
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "libs": libs, "kernel": kern,
               "model": whole, "serving": serve, "profile": prof,
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
