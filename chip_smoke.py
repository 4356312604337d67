"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--only e1|swinir|w96]

Drives the port's main paths -- the tester (``python -m
rdst_tpu_torch.test``) on the committed weights of the README quality
rows; the shipped RDST-E1 x4 config with its
committed weights, served over HTTP by ``rdst_tpu_torch.serving`` in
float32 and in bfloat16 (``inference_dtype='bfloat16'``) and trained in
bfloat16; the shipped SwinIR-std x4 configs, served and trained in
bfloat16; the shipped RDST-W96 x4 config, served in float32 as shipped
and in bfloat16 with int8 qkv -- and holds every CUDA kernel of those
paths against its plain PyTorch version on the card. Phases, each
printed with its seconds (the 20-phantom corpus is generated once,
after the build):

1. the card (``nvidia-smi`` name and power limit);
2. build every kernel source with ``nvcc`` (one process per source, all
   started together), with each ptxas report of registers and spills;
3. the f32 block kernel (six token-parallel kernels, 3xTF32 products)
   vs its plain version and the staged plain version of its phases at
   the main path's shapes (bucket 64: 64 slices x 20 windows): CUDA-event
   times, both bounds (f32 FMA and 3xTF32, the row taking the smaller),
   two launches bitwise equal, kernels a call and device time by phase
   (torch.profiler); then the same at C = 192 (RDST-W96's widest DSTL)
   and C = 180 (SwinIR-std's first RSTB), with their committed weights;
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
   under 'clamp' (the flagship's resolved variant) and 'stable_bc', in
   the design its plan picks (the persistent window kernel up to C =
   120: two launches bitwise equal at every variant) and the
   token-parallel forward timed beside it, each with its kernels a call,
   bitwise repeat and device time by phase; at C = 60 the window kernel
   also without its tensor-core turns (bitwise the same, timed beside
   it); the ptxas report of the window kernel (spills and wgmma
   serialization refused); int8 qkv at C = 96 on a seeded block, which
   the plan routes to the token-parallel forward, against its plain
   version and timed; the pair at C = 60/90/120, the RDSTB on the flagship
   geometry; CUDA-event times of the launch alone, plain time, bound,
   max and mean relative error (bar 0.02); for the pair and the RDSTB
   (stage kernels on ``csrc/window_body.cuh``) also the error against
   their staged plain versions, kernels a call, two calls bitwise equal
   and device time per stage kernel (torch.profiler); then both at
   16-token windows (window 4, random weights, 8 images) against their
   plain and staged versions, and the fast block's window kernel there at
   C = 60 and 120, unshifted and shifted;
8. the bf16 model in modes rdstb, pair and swin on 8 slices: launches per
   forward (8 / 24 / 48, counts set to 0 just before each and read just
   after), the kernel path vs the plain bf16 path, and vs the f32 kernel
   path (relative error and PSNR); and per mode the wall and device time
   (torch.profiler) of one warm bucket-64 forward;
9. bf16 serving (mode rdstb, the default): as phase 5;
10. the profile of one warm bf16 bucket-64 forward, as phase 6;
11. the train-pair kernels (``kernels.pair_train``: the forward one
    persistent launch on the window body in its training form, blocks a
    and b chained; the backward) vs their plain version and its
    ``torch.autograd`` gradient, with the flagship's weights at the
    training geometry (32 images of 24x24, C = 60/90/120; RDST-W96's C =
    96 with its committed weights in phase 24), with and without
    stochastic-depth factor columns, under 'clamp' and 'stable' (and
    'stable_mm' once, at C = 60): relative max error of the output, the
    input cotangent and every weight and bias gradient (bar 0.02);
    CUDA-event times, plain times (the plain backward alone, through a
    graph built once) and bounds; for the timed variant the forward
    launch alone (two launches bitwise equal, output and block a's y;
    kernels a call, 1; its device time; at C = 60, where it runs without
    the tensor-core turns, also with them) and the backward launch alone:
    two launches on the same inputs bitwise equal, the kernels a call
    (26: 13 a block), the result against the staged plain VJP
    (``block_bwd_reference``, the two blocks chained through the
    relayout; bar 0.02), and the device time of each phase of the
    backward (torch.profiler); the forward's ptxas report (spills and
    wgmma serialization refused); the forward's mean time over C;
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
    and the profile of one warm training step with its kernel launches;
14. SwinIR-std (``config_files/swinir_std_40k_oasis20_x4.ini``, its
    committed weights, bf16, mode swin, int8 qkv; every block unshifted
    at the build resolution): the fast block at C = 180 with int8 qkv vs
    its plain version at bucket 64 (1280 windows), the path's unshifted
    block and a shifted case, 'clamp' and 'stable_bc': CUDA-event times
    of the token-parallel forward, plain time, bound (the qkv product at
    the int8 peak), relative error (bar 0.02), kernels a call, two
    launches bitwise equal and device time by phase;
15. the SwinIR-std model on 8 slices: 36 fast-block launches per forward
    (counts set to 0 just before, read just after), vs the same model on
    the CPU (the plain versions, bar 0.02) and vs the plain f32 path
    (``pallas_kernels='off'``): relative error and PSNR;
16. SwinIR-std bf16 serving over HTTP, as phase 5, and the profile of
    one warm bucket-64 forward, as phase 6;
17. the block-train kernels (``kernels.block_train``: the forward on
    the token-parallel forward, five kernels, with the exact division and
    the factor columns; the backward) vs the plain version and its
    autograd gradient at 288 windows, C = 180 (the committed weights; the
    path's unshifted block and a shifted case, with and without factor
    columns, 'clamp' and 'stable'): the output and every gradient
    (tokens, the 12 parameters through the fold, the bias), bar 0.02;
    CUDA-event times, plain times, bounds; the forward launch alone (two
    launches bitwise equal, kernels a call, device time by phase) and its
    GEMMs at 18,432 tokens in tiles of 64 and 128 rows; the ptxas report
    of its GEMM kernels; the backward's extras as phase 11 (13 kernels a
    call); then RDST-W96's block-train widths C = 144 and 192 with its
    committed weights (shift 0 and 4, with and without factor columns)
    and their forward times;
18. SwinIR-std bf16 training (``config_files/swinir_std_100k_oasis20_x4
    .ini``, 20 steps, a quick evaluation every 10): ``train_routes`` 36
    block / 0 pair, 36 + 36 block-train wrapper calls a step and none of
    the train pair (counts set to 0 just before the run), a finite loss
    that falls, the quick evaluations on the fast block, the snapshot
    served by ``LiveModel``; the first step on the kernel route vs the
    plain bf16 route from the same generator state (the same
    stochastic-depth draws; loss rtol 2e-2, gradients < 0.08);
19. steps/s and the profile of one warm SwinIR-std training step, as
    phase 13;
20. the token-parallel forward's GEMMs alone (``csrc/token_wgmma.cuh``,
    ``kernels.token_wgmma``: the qkv product in int8 and bf16, proj +
    residual + LN2, fc1 + GELU + fc2 + residual fused, the adapter pre-
    and post-norm) on seeded operands at C = 96 / 144 / 180 / 192 and
    960 / 1280 / 81920 tokens: int8 bitwise against the exact integer
    sums, bf16 within 0.02; at 81920 tokens each one's device time beside
    its byte floor and a library product of the same shapes
    (``torch.matmul``, ``torch._int_mm``: the products alone); the ptxas
    registers of its kernels, no spills and no wgmma serialization
    allowed. Then RDST-W96 (``config_files/rdst_w96_40k_oasis20_x4.ini``,
    its committed 40k weights) kernels at bucket 64: the f32 block at C =
    96 / 144 / 192 as phase 3; the RDSTB with int8 qkv (three DSTLs on
    the token-parallel stages, the conv 240 -> 96) and the pair at C =
    96 / 144 / 192 with int8 qkv, each against its plain and staged
    versions (bar 0.02), two calls bitwise equal, kernels a call,
    CUDA-event times beside the bound and the plain time, device time
    by stage kernel, each GEMM phase beside its byte floor; the pair at
    C = 96 with bf16 qkv in both stage designs (window body,
    token-parallel) side by side;
21. the W96 model on 8 slices: f32 as shipped (48 f32 block launches a
    forward) against the plain f32 path (bar 1e-4); bf16 with int8 qkv
    in modes swin, rdstb and pair (48 / 8 / 24 launches a forward, counts
    set to 0 just before each and read just after) against the f32
    model (< 0.05 max, < 0.005 mean, relative) and against mode swin;
    per mode (and f32) the wall and device time of one bucket-64
    forward;
22. W96 f32 serving over HTTP, as phase 5;
23. W96 bf16 serving (mode rdstb, int8 qkv) over HTTP, as phase 5; then
    the profile of one warm bucket-64 forward in each dtype, as phase 6;
24. the train-pair kernels at W96's C = 96 with its committed weights, as
    phase 11;
25. W96 bf16 training (``config_files/rdst_w96_100k_oasis20_x4.ini`` with
    ``training_dtype='bfloat16'``, 20 steps, a quick evaluation every 10):
    ``train_routes`` 8 pair / 32 block, 8 + 8 train-pair and 32 + 32
    block-train calls a step (counts set to 0 just before the run), a
    finite loss that falls, the snapshot served in bf16 by ``LiveModel``;
    the first step on the kernel route vs the plain bf16 route (loss rtol
    2e-2, gradients < 0.08);
26. the tester path, at the end of each model's phases (``--only``
    keeps each model's rows): first the kernels at the tester's batch
    sizes against their plain versions -- one whole held-out patient in
    one forward (57 and 58 slices of LR 16x12, padded to 16x16: 228 and
    232 windows; and the same counts at 40x32, 1140 and 1160 windows) for
    the f32 block (E1 C = 60, W96 C = 96 / 192), the E1 and W96 RDSTBs
    (W96 with int8 qkv) and the C = 180 fast block with int8 qkv, and one
    tiled chunk (128 LR patches of 24x24) through E1 in f32 (kernel vs
    plain, MODEL_TOL) and bf16 (vs f32) and through the E1 RDSTB; then
    ``cli.test_main`` (``python -m rdst_tpu_torch.test``) on the card
    over patients 19-20 of the corpus for each README quality row:
    bicubic, E1 f32 as shipped, E1 bf16, E1 f32 tiled at stride 12 (one
    24x24 patch a slice here) and, without a bar, at patch 12 stride 6
    (four overlapping patches a slice, chunks of 128), the HRL and the
    two RaGAN fine-tunes (with vifp and lpips), SwinIR-light
    (f32), SwinIR-std (bf16, int8 qkv, as shipped), W96 in f32 as shipped,
    in bf16 (int8 qkv, as shipped) and in bf16 without int8. Each row
    prints its mean scores beside its bar, the JAX tester's own number on
    this corpus (``TESTER_BARS``), and its README figure: a row more than
    0.02 dB / 0.002 SSIM (vifp 0.002, lpips 1e-4) off its bar fails; E1
    bf16 and W96 bf16 without int8 must also hold 0.02 dB / 0.002 of
    their f32 rows, and the tiled rows stay within 2 dB of whole-slice SR
    (the stride-12 row, one zero-padded 24x24 patch a slice, scores above
    it: checked from below only). Each row also prints the kernel
    launches of its run (counts set to 0 just before, read just after:
    per forward 48 / 8 / 24 / 36 / 48 / 8) and per patient the tester's
    inference wall time and one warm forward's wall and device time.

27. (after phase 13) the seg fine-tune: ``config_files/
    rdst_hrl_seg_ft_oasis20_x4.ini`` with ``--seg-loss`` as shipped (f32,
    warm start, L1 + UNet-F), with ``unet_native_ckpt`` naming the
    committed seg UNet ``weights/unet_tiny.pkl`` (checked: the term's
    UNet holds its weights), for 12 steps with a quick evaluation every 6
    (the f32 block kernel in each evaluation, 48 launches a forward): the
    UNet-F term finite and above 0, the snapshot written; then the repo's
    example recipe ``config_files/rdst_e1_oasis_x4.ini`` (WarmUP ->
    UNet-F from scratch, the same UNet) for 3 steps a state; steps/s over
    10 warm steps and one profiled step (device time by kernel group,
    idle share, launches);
28. the GAN fine-tune: ``config_files/rdst_gan_ft_oasis20_x4.ini`` as
    shipped (RaGAN, CNN discriminator, f32, ``eva_metrics`` with FID)
    for 12 steps with a quick evaluation every 6: every loss finite, the
    discriminator's loss moving, the G and D snapshots written; the resume
    for 2 more steps; FID of the final evaluation's images on the card
    against the CPU (relative 1e-3) with both times; steps/s, one
    profiled step and the D update's share of its device time;
29. both recipes in bf16 (``training_dtype='bfloat16'``) for 6 steps:
    24 train-pair backward launches a step and 24 forward launches a
    generator forward (one a seg step, two a GAN step), no single-block
    train launch; the first step (the discriminator's update included) on
    the kernel route against the plain bf16 route from the same state and
    batch: every loss rtol 2e-2, the generator's gradient < 0.08; steps/s
    and one profiled step.

Each training run's final evaluation scores the config's ``eva_metrics``
as shipped (FID included). Any failed phase raises and the script exits
non-zero. It needs a CUDA
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
W96_CONFIG = "config_files/rdst_w96_40k_oasis20_x4.ini"
W96_WEIGHTS = "weights/rdst_w96_40k_best_oasis20_x4.msgpack"
LR_HW = (40, 32)
SCALE = 4.0
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, dense bf16 on
# the tensor cores, HBM3 bandwidth
F32_FLOPS = 67e12
TF32_FLOPS = 494e12  # dense TF32 tensor cores: the f32 kernel's 3xTF32
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


# cuDNN's convolution kernels by name, its FFT algorithms included
CONV_KERNELS = ("conv", "cudnn", "xmma", "implicit", "fft",
                "pointwise_mult_and_sum_complex")


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
    out = {}
    for src, path in libs.items():
        log(f"built {src} -> {path.name}")
        ptxas = [line.strip() for line in _build.build_log(src).splitlines()
                 if "registers" in line or "spill" in line]
        for line in ptxas:
            log(f"  ptxas: {line}")
        out[src] = {"library": str(path), "ptxas": ptxas}
    return out


def _block_work(block, c: int, windows: int):
    """Flops and bytes of one launch: 16C^2 + 4NC flops per token; the
    input and output rows, every weight and the bias, each once."""
    n = 64
    flops = windows * n * (16 * c * c + 4 * n * c)
    weights = sum(p.numel() for name, p in block.named_parameters()
                  if not name.endswith("relative_position_bias_table"))
    return flops, weights


def _f32_variant(block, shift: int, gen, kernels: int) -> dict:
    """The f32 block kernel's launch alone for one block of a model
    (weights split once, as the model keeps them) at bucket 64 (64 slices
    x 20 windows): against its plain version and the staged plain version
    of its phases (bar KERNEL_TOL), CUDA-event times, both bounds (f32 FMA
    and 3xTF32), kernels a call, two launches bitwise equal and device
    time by phase."""
    from rdst_tpu_torch.kernels import swin_block as sb

    ws, nw, images, nh = 8, 20, 64, block.num_heads
    c = block.dim
    params, bias = block.kernel_inputs(LR_HW, ws, shift)
    x = torch.randn(images * nw, ws * ws, c, device="cuda", generator=gen)
    kw = dict(num_heads=nh, windows_per_image=nw)
    with torch.inference_mode():
        plan = sb.plan_f32_block(params, bias, num_heads=nh)
        got = sb.run_f32_block(x, plan, **kw)
        want = sb.swin_block_reference(x, *plan.params, bias, **kw)
        staged = sb.swin_block_staged_f32(x, *plan.params, bias, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_staged = (got - staged).abs().max().item()
        if not (max(err, err_staged) <= KERNEL_TOL
                and torch.isfinite(got).all()):
            raise AssertionError(
                f"fused_swin_block C={c} shift={shift}: max abs err {err} "
                f"(staged {err_staged}) > {KERNEL_TOL}")

        def call():
            return sb.run_f32_block(x, plan, **kw)

        ms = cuda_time_ms(call)
        plain_ms = cuda_time_ms(
            lambda: sb.swin_block_reference(x, *plan.params, bias, **kw))
        flops, weights = _block_work(block, c, images * nw)
        extras = _forward_extras(f"f32 block C={c} shift={shift}", call,
                                 kernels, F32_PHASES, flops)
    nbytes = 4 * (2 * x.numel() + weights + bias.numel())
    row = dict(c=c, shift=shift, windows=images * nw, max_abs_err=err,
               staged_max_abs_err=err_staged, ms=ms, plain_ms=plain_ms,
               **_f32_bound(flops, nbytes), **extras)
    log(f"fused_swin_block C={c:3d} shift={shift}: err {err:.3e} (staged "
        f"{err_staged:.3e}; tol {KERNEL_TOL}) kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, 3xTF32; f32 FMA {row['fma_bound_ms']:.4f} ms) "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return row


def _f32_kernels() -> int:
    from rdst_tpu_torch.kernels import swin_block as sb

    return sb.kernels_per_call("swin_block.cu", "swin_block_f32_kernels")


def _rdst_blocks(model):
    """(block, shift) of the first RDSTB's DSTLs: block a unshifted,
    block b at shift 4, widths ascending."""
    return [(blk, k * 4) for dstl in model.body[0].body
            for k, blk in enumerate(dstl.body.blocks)]


@phase("kernel vs plain")
def kernel_phase(model) -> dict:
    """The f32 block kernel (``_f32_variant``) for the six (C, shift)
    variants of the flagship's first RDSTB, C = 60/90/120."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = _f32_kernels()
    rows = [_f32_variant(blk, shift, gen, kernels)
            for blk, shift in _rdst_blocks(model)]
    log("library yardstick: no single PyTorch call computes a whole Swin "
        "block (LN, qkv, biased softmax attention, proj, LN, GELU MLP)")
    return {"variants": rows}


@phase("kernel vs plain at C = 180 / 192")
def wide_kernel_phase() -> dict:
    """Phase 3 at the widths the f32 route admits since the kernel's own
    limits became its rule (``_f32_variant``): C = 192 (RDST-W96's widest
    DSTL, its committed weights) and C = 180 (SwinIR-std's first RSTB,
    its committed weights), each an unshifted and a shifted block."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    kernels = _f32_kernels()
    w96 = _build_f32(W96_CONFIG, W96_WEIGHTS)
    swinir = _build_f32(SWINIR_CONFIG, SWINIR_WEIGHTS, pallas_kernels="swin")
    cases = _rdst_blocks(w96)[4:] + [
        (blk, k * 4) for k, blk in
        enumerate(swinir.layers[0].residual_group.blocks[:2])]
    return {"variants": [_f32_variant(blk, shift, gen, kernels)
                         for blk, shift in cases]}


def _f32_bound(flops: float, nbytes: float) -> dict:
    """The f32 block's bounds: its work at the f32 FMA peak and at the
    TF32 tensor-core peak counted three times (3xTF32), each against the
    bytes; the row takes the smaller operations time."""
    t_fma = flops / F32_FLOPS * 1e3
    t_tf32 = 3 * flops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(t_fma, t_tf32)
    return dict(flops=flops, bytes=nbytes, fma_bound_ms=max(t_fma, t_bytes),
                tf32_bound_ms=max(t_tf32, t_bytes),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _build_f32(config: str, weights: str, **overrides):
    """A shipped config's float32 model with its committed weights on the
    card (``build_serving_model``)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import build_serving_model

    p = ParametersLoader(config)
    p.set("well_trained_single_scale_model_g", weights)
    p.set("inference_dtype", "float32")
    for k, v in overrides.items():
        p.set(k, v)
    model, meta = build_serving_model(p, device="cuda")
    if set(meta["routes"]) != {"fused_swin_block"}:
        raise AssertionError(f"{config} in f32: routes {meta['routes']}")
    return model


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


def _profile(live, kernels=None, group: str = "f32 block kernels") -> dict:
    """Device time of one warm bucket-64 forward by kernel group
    (torch.profiler / CUPTI), and the device's idle share of the
    forward's wall time (numpy in, numpy out); a kernel whose name holds
    one of ``kernels`` (default: the f32 block's, F32_PHASES) is in the
    port's group ``group``."""
    if kernels is None:
        kernels = tuple(key for key, _ in F32_PHASES)
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
    groups = {group: 0.0, "convolution": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        # device kernels only: the CPU ops that launch them report the
        # same time again
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        name = e.key.lower()
        if any(k.lower() in name for k in kernels):
            groups[group] += t
        elif any(w in name for w in CONV_KERNELS):
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
    """A block's weights and bias as the work reads them once: the
    kernel_layout arrays (the stage kernels' panels pad them further, and
    their fragment-ordered bias repeats the packed one) and the packed
    bias."""
    from rdst_tpu_torch.kernels.swin_block import kernel_layout

    layout = kernel_layout(plan.params) if plan.route != "tokens" \
        else plan.layout
    return sum(t.numel() * t.element_size() for t in layout) + \
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
    tok_kernels = swin_block.kernels_per_call(
        "swin_block_fast.cu", "swin_block_fast_tokens_kernels")
    for softmax in ("clamp", "stable_bc"):
        for j, c in enumerate((60, 90, 120)):
            for k, shift in enumerate((0, ws // 2)):
                blk = rdstb.body[j].body.blocks[k]
                inputs = blk.fast_kernel_inputs(LR_HW, ws, shift)
                plan = swin_block.plan_fast_block(*inputs, num_heads=nh)
                if plan.route != "window":
                    raise AssertionError(f"fast block C={c}: route "
                                         f"{plan.route}")
                # the other design at this width, timed beside the plan's
                plan_o = swin_block.plan_fast_block(*inputs, num_heads=nh,
                                                    route="tokens")
                x = torch.randn(images * nw, ws * ws, c, device="cuda",
                                generator=gen).to(torch.bfloat16)
                kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
                with torch.inference_mode():
                    got = swin_block.run_fast_block(x, plan, **kw)
                    again = swin_block.run_fast_block(x, plan, **kw)
                    got_o = swin_block.run_fast_block(x, plan_o, **kw)
                    want = swin_block.swin_block_fast_reference(
                        x, plan.params, plan.bias, num_heads=nh,
                        softmax=softmax)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"fast block C={c} shift="
                                             f"{shift} {softmax}: two "
                                             "launches differ")
                    err = _check(f"fast block C={c} shift={shift} {softmax}",
                                 got, want)
                    err_o = _check(f"fast block C={c} shift={shift} "
                                   f"{softmax} (tokens)", got_o, want)
                    ms = cuda_time_ms(lambda: swin_block.run_fast_block(
                        x, plan, **kw))
                    ms_o = cuda_time_ms(lambda: swin_block.run_fast_block(
                        x, plan_o, **kw))
                    plain_ms = cuda_time_ms(
                        lambda: swin_block.swin_block_fast_reference(
                            x, plan.params, plan.bias, num_heads=nh,
                            softmax=softmax))
                    flops = _block_flops(images * nw, c)
                    extras, free = {}, {}
                    if softmax == "clamp" and shift == 0:
                        extras = {
                            "window": _forward_extras(
                                f"fast block C={c} (window kernel)",
                                lambda: swin_block.run_fast_block(
                                    x, plan, **kw), 1, WINDOW_PHASES, flops),
                            "tokens": _forward_extras(
                                f"fast block C={c} (tokens)",
                                lambda: swin_block.run_fast_block(
                                    x, plan_o, **kw),
                                tok_kernels, FAST_PHASES, flops)}
                    if c == 60 and softmax == "clamp":
                        free = _without_turns(x, plan, nh, softmax, got, ms)
                bound_ms, by = _bound(flops, 2 * 2 * x.numel()
                                      + _plan_bytes(plan))
                row = dict(c=c, shift=shift, softmax=softmax, rel_max=err[0],
                           rel_mean=err[1], max_abs_err=err[2], ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           route=plan.route, other_route=plan_o.route,
                           other_ms=ms_o, other_rel_max=err_o[0],
                           extras=extras, without_turns=free)
                out["block"].append(row)
                log(f"fast block C={c:3d} shift={shift} {softmax:9s}: rel "
                    f"max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}) "
                    f"kernel ({plan.route}) {ms:.4f} ms, tokens {ms_o:.4f} "
                    f"ms (rel max {err_o[0]:.3e}); plain {plain_ms:.4f} ms "
                    f"bound {bound_ms:.4f} ms ({by}, "
                    f"{flops / ms / 1e9:.1f} TFLOP/s)")
    # the instantiations the E1 blocks launch: 32 NT output columns, NT 2
    # / 3 / 4 at C = 60 / 90 / 120
    out["ptxas"] = _ptxas_check("swin_block_fast.cu", "fast_window_kernel",
                                path=("ILi2E", "ILi3E", "ILi4E"))
    out["int8_c96"] = _int8_window_case(gen)
    softmax = model.softmax
    for j, c in enumerate((60, 90, 120)):
        layer = rdstb.body[j].body
        a, b = layer.blocks
        plan_a = swin_block.plan_fast_block(
            *a.fast_kernel_inputs(LR_HW, ws, 0), num_heads=nh, route="stage")
        plan_b = swin_block.plan_fast_block(
            *b.fast_kernel_inputs(LR_HW, ws, ws // 2), num_heads=nh,
            route="stage")
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
                  softmax=softmax)
        args = (x, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias)
        with torch.inference_mode():
            got = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
            want = swin_pair.swin_pair_reference(*args, **kw)
            staged = swin_pair.swin_pair_staged_reference(*args, **kw)
            torch.cuda.synchronize()
            err = _check(f"pair C={c}", got, want)
            err_s = _check(f"pair C={c} vs staged", got, staged)
            ms = cuda_time_ms(lambda: swin_pair.run_swin_pair(
                x, plan_a, plan_b, **kw))
            plain_ms = cuda_time_ms(lambda: swin_pair.swin_pair_reference(
                *args, **kw))
            nt = (c + 31) // 32
            extras = _stage_extras(
                f"pair C={c}",
                lambda: swin_pair.run_swin_pair(x, plan_a, plan_b, **kw),
                swin_pair.run_swin_pair,
                ((f"stage_kernel<{nt}, false>", f"stage A, C = {c}"),
                 (f"stage_kernel<{nt}, true>", f"stage B, C = {c}")))
        flops = 2 * _block_flops(images * nw, c)
        bound_ms, by = _bound(flops, 2 * 2 * x.numel() + _plan_bytes(plan_a)
                              + _plan_bytes(plan_b))
        out["pair"].append(dict(c=c, rel_max=err[0], rel_mean=err[1],
                                max_abs_err=err[2], staged_rel_max=err_s[0],
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=by, **extras))
        log(f"pair C={c:3d} {softmax}: rel max {err[0]:.3e} mean "
            f"{err[1]:.3e}, vs staged {err_s[0]:.3e}; kernels {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by}, "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
    h, w = LR_HW
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(LR_HW, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm)
    x = torch.randn(images, h * w, 60, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax=softmax)
    rkw = dict(growth=plan.growth, adapter_prenorm=plan.prenorm, **kw)
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(x, plan.dstls, plan.wc, plan.bc,
                                           **rkw)
        staged = rdstb_block.rdstb_staged_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw)
        torch.cuda.synchronize()
        err = _check("rdstb", got, want)
        err_s = _check("rdstb vs staged", got, staged)
        ms = cuda_time_ms(lambda: rdstb_block.run_rdstb(x, plan, **kw))
        plain_ms = cuda_time_ms(lambda: rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw), warmup=1, iters=5)
        phases = []
        for c in (60, 90, 120):
            nt = (c + 31) // 32
            phases += [(f"stage_kernel<{nt}, false>", f"stage A, C = {c}"),
                       (f"stage_kernel<{nt}, true>",
                        f"stage B + adapter, C = {c}")]
        extras = _stage_extras(
            "rdstb", lambda: rdstb_block.run_rdstb(x, plan, **kw),
            rdstb_block.run_rdstb, tuple(phases) + (("conv_kernel", "conv"),))
    # blocks of the three DSTLs, plus the 3x3 conv from 150 to 60 channels;
    # bytes: tokens in and out, every weight and bias once
    flops = sum(2 * _block_flops(images * nw, c) for c in (60, 90, 120)) \
        + images * h * w * 2 * 9 * 150 * 60
    nbytes = 2 * 2 * x.numel() + sum(
        t.numel() * t.element_size() for d in plan.dstls
        for t in (*d.pa, *d.pb, d.bias_a, d.bias_b, *d.adapter)) + sum(
        t.numel() * t.element_size() for t in (plan.wc, plan.bc))
    bound_ms, by = _bound(flops, nbytes)
    out["rdstb"].append(dict(rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], staged_rel_max=err_s[0],
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by, flops=flops, **extras))
    log(f"rdstb {softmax}: rel max {err[0]:.3e} mean {err[1]:.3e}, vs "
        f"staged {err_s[0]:.3e}; kernels {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms bound {bound_ms:.4f} ms ({by}, {flops / ms / 1e9:.1f} TFLOP/s)")
    out["window16"] = _window16_cases(gen)
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
    x64 = rng.random((64,) + LR_HW, dtype=np.float32)
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
            wall, busy = _device_ms(lambda: live16.predict(x64, SCALE))
            log(f"bf16 mode {mode}: one warm bucket-64 forward {wall:.3f} ms "
                "wall, device " + (f"{busy:.3f} ms" if busy is not None
                                   else "not measured (no profiler time)"))
            out[mode] = {"launches_per_forward": launches[counter.__name__],
                         "vs_plain_versions_rel_max": kp[0],
                         "vs_plain_modules_rel_max": ko[0],
                         "vs_f32_rel_max": kf[0], "vs_f32_rel_mean": kf[1],
                         "psnr_vs_f32_db": kf[2],
                         "bucket64_wall_ms": wall,
                         "bucket64_device_ms": busy}
    finally:
        set_kernel_mode(model, "rdstb", softmax)
    return out


bf16_serving_phase = phase("bf16 serving")(_serve)
bf16_profile_phase = phase("bf16 profile")(_profile)


def _pair_train_operands(model, j: int, c: int, gen):
    """Folded weights of the first RDSTB's DSTL j (width c) of ``model`` at
    the training geometry, with random bf16 tokens and cotangents."""
    from rdst_tpu_torch.kernels.swin_block import fast_params, pack_bias_fast

    ws, nh, images, nw = 8, 6, 32, 9
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


# The backward's kernels by phase (csrc/block_bwd.cuh), as the profiler
# names them: (part of the kernel's name, phase)
BWD_PHASES = (
    ("prep_weights", "weights padded"),
    ("rows_kernel", "LN1 rows, fm dz"),
    ("EpiQkv", "qkv GEMM"),
    ("attn_fwd", "attention forward"),
    ("EpiProjLn", "proj GEMM + residual + LN2"),
    ("EpiFc1", "fc1 GEMM + GELU"),
    ("EpiDu", "dh2 W2^T GEMM -> du"),
    ("EpiLn2Bwd", "du W1^T GEMM + LN2 VJP"),
    ("EpiDout", "dy Wproj^T GEMM -> dO"),
    ("attn_vjp", "attention VJP"),
    ("EpiLn1Bwd", "dqkv Wqkv^T GEMM + LN1 VJP"),
    ("wgrad", "weight gradients (split K)"),
    ("reduce_kernel", "fixed-order sums"),
)


def _flat(tree):
    """The tensors of a nested tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for part in tree for t in _flat(part)]


# The f32 block's kernels (csrc/swin_block.cu) and the token-parallel fast
# block's (csrc/swin_block_fast.cu), as the profiler names them
F32_PHASES = (
    ("ln1_kernel", "LN1 rows"),
    ("EpiQkv", "qkv GEMM (3xTF32) + bias, q scale"),
    ("attn_kernel", "attention (f32 FMA)"),
    ("EpiProjLn", "proj GEMM (3xTF32) + residual + LN2"),
    ("EpiFc1", "fc1 GEMM (3xTF32) + erf GELU"),
    ("EpiOut", "fc2 GEMM (3xTF32) + residual"),
)
FAST_PHASES = (
    ("ln1_rows_kernel", "LN1 rows (int8 or bf16)"),
    ("EpiQkvS8", "qkv GEMM (int8, wgmma .s8)"),
    ("EpiQkv", "qkv GEMM (bf16, wgmma)"),
    ("attn_fwd_kernel", "attention"),
    ("EpiProjLn", "proj GEMM + residual + LN2 (wgmma)"),
    ("mlp_kernel", "fc1 + tanh GELU + fc2 + residual (wgmma, fused)"),
)

# the persistent window kernel of the fast block at C <= 120
WINDOW_PHASES = (("fast_window_kernel", "persistent window kernel"),)


def _without_turns(x, plan, nh: int, softmax: str, got, ms: float) -> dict:
    """The persistent window kernel with its warpgroups free of the
    tensor-core turns (``window_kernel_without_turns``; every weight
    resident): bitwise the kernel's output, and its time beside the
    kernel's, which says what the turns overlap."""
    from rdst_tpu_torch.kernels import swin_block

    def call():
        return swin_block.window_kernel_without_turns(
            x, plan, num_heads=nh, softmax=softmax)

    free = call()
    torch.cuda.synchronize()
    if not torch.equal(free, got):
        raise AssertionError("the window kernel without turns differs from "
                             "the kernel")
    ms_free = cuda_time_ms(call)
    log(f"  without turns: {ms_free:.4f} ms against {ms:.4f} ms with them "
        f"({(ms_free - ms) / ms_free:+.1%} of the time taken off by the "
        "turns); bitwise equal")
    return {"ms": ms_free, "ms_with_turns": ms}


def _ptxas_check(source: str, key: str, path=None) -> dict:
    """The ptxas report of the kernels of ``source`` whose names hold
    ``key``: registers, spill bytes and wgmma serialization warnings,
    logged; a spill or a warning fails the phase for a kernel on the main
    path (every one, or those whose names hold an item of ``path``); one
    off the path is logged as such."""
    rep = {k: v for k, v in _ptxas_kernels(source).items() if key in k}
    if not rep:
        raise AssertionError(f"no ptxas report of {key} in {source}")
    for name, r in rep.items():
        on = path is None or any(p in name for p in path)
        log(f"  ptxas {source} {name}: {r['registers']} registers, "
            f"{r['spill_bytes']} spill bytes, {len(r['warnings'])} wgmma "
            "serialization warnings" + ("" if on else " (not on the path)"))
        r["on_path"] = on
        if on and (r["spill_bytes"] or r["warnings"]):
            raise AssertionError(f"{name} spills or serializes wgmma: {r}")
    return rep


def _int8_window_case(gen) -> dict:
    """int8 qkv at C = 96 (RDST-W96's first DSTL width in mode swin) on a
    seeded block, bucket 64: the plan routes it to the token-parallel
    forward (the window body has no int8 product); against the plain
    version with the same int8 operands, two launches bitwise equal, its
    time beside the plain time and the bound."""
    from rdst_tpu_torch.kernels import swin_block

    c, nh, ws, nw, images = 96, 6, 8, 20, 64
    rng = np.random.default_rng(SEED + 11)
    plan = swin_block.plan_fast_block(*_random_block(rng, c, nh, ws, False),
                                      num_heads=nh,
                                      quant=frozenset({"qkv"}))
    if plan.route != "tokens":
        raise AssertionError(f"int8 qkv at C = 96: route {plan.route}")
    x = torch.randn(images * nw, ws * ws, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, windows_per_image=nw, softmax="clamp")
    with torch.inference_mode():
        got = swin_block.run_fast_block(x, plan, **kw)
        again = swin_block.run_fast_block(x, plan, **kw)
        want = swin_block.swin_block_fast_reference(
            x, plan.params, plan.bias, num_heads=nh, softmax="clamp",
            qkv=plan.qkv)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("int8 C = 96: two launches differ")
        err = _check("fast block C=96 int8 qkv (tokens)", got, want)
        ms = cuda_time_ms(lambda: swin_block.run_fast_block(x, plan, **kw))
        plain_ms = cuda_time_ms(lambda: swin_block.swin_block_fast_reference(
            x, plan.params, plan.bias, num_heads=nh, softmax="clamp",
            qkv=plan.qkv))
    bound_ms, by = _int8_qkv_bound(images * nw * ws * ws, c,
                                   2 * 2 * x.numel() + _plan_bytes(plan))
    log(f"fast block C= 96 int8 qkv (tokens): rel max {err[0]:.3e}; "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by}); two launches bitwise equal")
    return dict(rel_max=err[0], max_abs_err=err[2], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, route=plan.route)


def _phase_ms(call, iters: int = 5, phases=BWD_PHASES) -> dict:
    """Device time of one call by phase (torch.profiler, CUPTI; a kernel
    whose name holds a key of ``phases`` counts to its phase), ms per
    call; {} when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        label = next((ph for key, ph in phases if key in e.key), "other")
        out[label] = out.get(label, 0.0) + t / iters / 1e3
    return out


def _backward_extras(label: str, call, counter, vjp: int, staged) -> dict:
    """The backward launch alone at the timed variant: two launches on
    the same inputs bitwise equal; kernels per call (``reductions`` counts
    those beside the ``vjp`` attention VJP kernels of a call); the result
    against the staged plain VJP (``block_bwd_reference``), bar BF16_TOL;
    device time per phase."""
    counter.launches = counter.reductions = 0
    first = _flat(call())
    torch.cuda.synchronize()
    kernels = (counter.reductions + vjp * counter.launches) / counter.launches
    second = _flat(call())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two backward launches on the same "
                             "inputs differ")
    want = _flat(staged())
    errs = [_rel(a, b)[0] for a, b in zip(first, want)]
    finite = all(bool(torch.isfinite(a.float()).all()) for a in first)
    if not finite or max(errs) > BF16_TOL:
        raise AssertionError(f"{label}: backward vs the staged plain VJP "
                             f"{errs} (finite={finite})")
    phases = _phase_ms(call)
    log(f"  {label} backward: two launches bitwise equal; {kernels:g} "
        f"kernels a call; vs the staged plain VJP rel max {max(errs):.3e} "
        f"(bar {BF16_TOL})")
    if phases:
        total = sum(phases.values())
        log(f"  {label} backward by phase (torch.profiler, ms a call; "
            f"{total:.4f} in all):")
        for ph, ms in phases.items():
            log(f"    {ms:8.4f}  {ph}")
    else:
        log("  torch.profiler recorded no device time: phases not measured")
    return {"deterministic": True, "kernels_per_call": kernels,
            "staged_rel_max": max(errs), "phases_ms": phases}


def _forward_extras(label: str, call, kernels: int, phases, flops: float):
    """A redesigned forward's launch alone: two launches on the same
    inputs bitwise equal, its kernels a call, device time per phase
    (torch.profiler) and the achieved rate of the block's work."""
    first = call()
    torch.cuda.synchronize()
    second = call()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{label}: two launches on the same inputs "
                             "differ")
    ms = _phase_ms(call, phases=phases)
    total = sum(ms.values())
    rate = flops / total / 1e9 if total else None
    if ms:
        log(f"  {label}: two launches bitwise equal; {kernels} kernels a "
            f"call; by phase (torch.profiler, ms a call; {total:.4f} in all, "
            f"{rate:.1f} TFLOP/s of block work):")
        for ph, t in ms.items():
            log(f"    {t:8.4f}  {ph}")
    else:
        log(f"  {label}: two launches bitwise equal; {kernels} kernels a "
            "call; torch.profiler recorded no device time: phases not "
            "measured")
    return {"deterministic": True, "kernels_per_call": kernels,
            "phases_ms": ms, "phase_tflops": rate}


def _stage_extras(label: str, call, counter, phases) -> dict:
    """A stage-kernel call alone (the pair's or the RDSTB's): two calls on
    the same inputs bitwise equal; the kernels a call (the wrapper's
    ``kernels`` count over its ``launches``); device time per stage
    kernel (torch.profiler)."""
    counter.launches = counter.kernels = 0
    first = call()
    torch.cuda.synchronize()
    kernels = counter.kernels / counter.launches
    second = call()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    ms = _phase_ms(call, phases=phases)
    total = sum(ms.values())
    if ms:
        log(f"  {label}: two calls bitwise equal; {kernels:g} kernels a "
            f"call; by stage (torch.profiler, ms a call; {total:.4f} in "
            "all):")
        for ph, t in ms.items():
            log(f"    {t:8.4f}  {ph}")
    else:
        log(f"  {label}: two calls bitwise equal; {kernels:g} kernels a "
            "call; torch.profiler recorded no device time: stages not "
            "measured")
    return {"deterministic": True, "kernels_per_call": kernels,
            "stages_ms": ms}


def _random_block(rng, c: int, nh: int, ws: int, shifted: bool):
    """A seeded 12-param bundle (JAX layout) and head-major bf16 bias
    (rel-pos, + the shift mask per window when shifted) for window ws on
    the LR_HW image, on the card."""
    from rdst_tpu_torch.nn.swin import (relative_position_index,
                                        shift_attention_mask)

    n, hid = ws * ws, 2 * c
    h, w = LR_HW

    def f(*shape, scale=0.2):
        return torch.from_numpy(rng.normal(0.0, scale, shape).astype(
            np.float32)).cuda()

    params = [f(c, 3 * c, scale=c ** -0.5), f(3 * c),
              f(c, c, scale=c ** -0.5), f(c), 1.0 + f(c), f(c), 1.0 + f(c),
              f(c), f(c, hid, scale=c ** -0.5), f(hid),
              f(hid, c, scale=hid ** -0.5), f(c)]
    table = rng.normal(0.0, 1.0, ((2 * ws - 1) ** 2, nh)).astype(np.float32)
    rel = table[relative_position_index(ws, ws).reshape(-1)].reshape(
        n, n, nh).transpose(2, 0, 1)
    if shifted:
        rel = (rel[:, None] + shift_attention_mask(h, w, ws, ws // 2)[None]
               ).reshape(-1, n, n)
    bias = torch.from_numpy(np.ascontiguousarray(rel, np.float32)).cuda()
    return params, bias.to(torch.bfloat16)


def _window16_cases(gen) -> dict:
    """16-token windows (window 4, which both gates admit at the flagship
    widths) on seeded random weights, 8 images: the pair at C = 60 and a
    whole RDSTB (C0 = 60, growth 30, 3 DSTLs, pre-norm adapters), each
    against its plain and staged versions (bar BF16_TOL), two calls
    bitwise equal; then the fast block's window kernel at C = 60 and 120,
    unshifted and shifted, against its plain version."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    ws, nh, images, c0, g = 4, 6, 8, 60, 30
    h, w = LR_HW
    nw = (h // ws) * (w // ws)
    if not (swin_block.fast_kernel_supports(16, c0, nh, 2 * c0)
            and rdstb_block.rdstb_kernel_supports(16, c0, g, 3, nh, 2.0)):
        raise AssertionError("the gates refuse 16-token windows at C0 = 60")
    rng = np.random.default_rng(SEED + 7)
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax="clamp")
    out = {}
    plan_a = swin_block.plan_fast_block(*_random_block(rng, c0, nh, ws, False),
                                        num_heads=nh, route="stage")
    plan_b = swin_block.plan_fast_block(*_random_block(rng, c0, nh, ws, True),
                                        num_heads=nh, route="stage")
    x = torch.randn(images * nw, ws * ws, c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    args = (x, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias)
    with torch.inference_mode():
        got = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
        again = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
        want = swin_pair.swin_pair_reference(*args, **kw)
        staged = swin_pair.swin_pair_staged_reference(*args, **kw)
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("pair, window 4: two calls differ")
    out["pair"] = {"rel_max": _check("pair window 4", got, want)[0],
                   "staged_rel_max": _check("pair window 4 vs staged", got,
                                            staged)[0]}
    dstls, c = [], c0
    for _ in range(3):
        blocks = [_random_block(rng, c, nh, ws, s) for s in (False, True)]

        def f(*shape, scale=0.2):
            return torch.from_numpy(rng.normal(0.0, scale, shape).astype(
                np.float32)).cuda()

        dstls.append({"blocks": blocks, "adapter": (
            f(c, g, scale=c ** -0.5), f(g), 1.0 + f(c), f(c))})
        c += g
    wconv = torch.from_numpy(rng.normal(0.0, (9 * c) ** -0.5, (3, 3, c, c0))
                             .astype(np.float32)).cuda()
    bconv = torch.from_numpy(rng.normal(0.0, 0.2, c0).astype(
        np.float32)).cuda()
    plan = rdstb_block.plan_rdstb(dstls, wconv, bconv, num_heads=nh,
                                  growth=g, adapter_prenorm=True)
    x = torch.randn(images, h * w, c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    rkw = dict(growth=g, adapter_prenorm=True, **kw)
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        again = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(x, plan.dstls, plan.wc, plan.bc,
                                           **rkw)
        staged = rdstb_block.rdstb_staged_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw)
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("rdstb, window 4: two calls differ")
    out["rdstb"] = {"rel_max": _check("rdstb window 4", got, want)[0],
                    "staged_rel_max": _check("rdstb window 4 vs staged", got,
                                             staged)[0]}
    out["block"] = {}
    for c in (60, 120):  # the window kernel, weights resident / streamed
        for shifted in (False, True):
            plan = swin_block.plan_fast_block(
                *_random_block(rng, c, nh, ws, shifted), num_heads=nh)
            if plan.route != "window":
                raise AssertionError(f"window 4, C={c}: route {plan.route}")
            x = torch.randn(images * nw, ws * ws, c, device="cuda",
                            generator=gen).to(torch.bfloat16)
            fkw = dict(num_heads=nh, windows_per_image=nw, softmax="clamp")
            with torch.inference_mode():
                got = swin_block.run_fast_block(x, plan, **fkw)
                again = swin_block.run_fast_block(x, plan, **fkw)
                want = swin_block.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh, softmax="clamp")
                torch.cuda.synchronize()
            label = f"fast block window 4 C={c} shift={ws // 2 * shifted}"
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two launches differ")
            out["block"][label] = _check(label, got, want)[0]
    log(f"window 4 (16-token windows, {images} images, random weights): "
        f"pair rel max {out['pair']['rel_max']:.3e} (staged "
        f"{out['pair']['staged_rel_max']:.3e}), rdstb rel max "
        f"{out['rdstb']['rel_max']:.3e} (staged "
        f"{out['rdstb']['staged_rel_max']:.3e}), fast block rel max "
        + ", ".join(f"{v:.3e}" for v in out["block"].values())
        + "; two calls bitwise equal")
    return out


def _profiled(fn):
    """(wall us, the profiler's CUDA events) of one call of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    return wall_us, events, [e for e in events
                             if e.device_type == DeviceType.CUDA]


def _device_ms(fn):
    """(wall ms, device ms) of one warm fn(): the host clock around it to
    a synchronize, and the sum of its kernels' device time by
    torch.profiler (None when the profiler records none)."""
    fn()
    torch.cuda.synchronize()
    wall, _, device = _profiled(fn)
    busy = sum(float(e.self_device_time_total or 0.0) for e in device)
    return wall / 1e3, (busy / 1e3 if busy else None)


# the train pair's forward (csrc/pair_train.cu), as the profiler names it
TRAIN_FWD_PHASES = (("pair_train_fwd_kernel", "persistent chained window "
                     "kernel"),)


def _kernels_per_call(call, iters: int = 5) -> dict:
    """The CUDA kernels of a call by torch.profiler (memory sets and
    copies apart): ``kernels``, the distinct kernels launched (each call
    is the same), and ``events``, the kernel events recorded a call; 0
    when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and "memset" not in e.key.lower()
             and "memcpy" not in e.key.lower()}
    return {"kernels": len(names),
            "events": sum(names.values()) / iters, "names": sorted(names)}


def _train_pair_widths(model, widths, label: str) -> list:
    """The train-pair kernels at the training geometry (32 images of 24x24,
    window 8, shift 4) with ``model``'s weights, the first RDSTB's DSTLs of
    the given widths: each variant's output and every gradient against
    the plain version and its autograd (bar BF16_TOL); at the timed variant
    ('clamp', no factor columns) the forward launch alone (two launches
    bitwise equal, output and y, kernels a call, device time), its time
    by CUDA events beside its bound and the plain version's, at C = 60
    also with the tensor-core turns; the backward's extras."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels.swin_block import FastParams, softmax_code
    from rdst_tpu_torch.kernels.swin_pair import (shift_relayout,
                                                  unshift_relayout)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    names = (["x"] + [f"a.{f}" for f in FastParams._fields] + ["bias_a"]
             + [f"b.{f}" for f in FastParams._fields] + ["bias_b"])
    rows = []
    for j, c in widths:
        ops, x, dz, dpf0 = _pair_train_operands(model, j, c, gen)
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
            log(f"train pair {label} C={c:3d} {softmax:9s} "
                f"dpf={use_dpf!s:5s}: out rel max {errs['out'][0]:.3e}, dx "
                f"{errs['x'][0]:.3e}, worst {worst} "
                f"{errs[worst][0]:.3e} (bar {BF16_TOL})")
            if not finite or errs[worst][0] > BF16_TOL:
                raise AssertionError(f"train pair {label} C={c} {softmax} "
                                     f"dpf={use_dpf}: {errs}")
            row = dict(c=c, model=label, softmax=softmax, dpf=use_dpf,
                       rel_max={k: v[0] for k, v in errs.items()},
                       out_abs_err=errs["out"][2],
                       grad_abs_err=max(v[2] for k, v in errs.items()
                                        if k != "out"))
            if softmax == "clamp" and not use_dpf:
                geom = ((24, 24), 8, 4, 6, softmax_code(softmax))
                pa, pb = FastParams(*ops[:8]), FastParams(*ops[9:17])
                ba, bb = ops[8], ops[17]
                # the launch alone: weights laid out once
                oa, ob = pt.forward_layout(pa, ba, pb, bb, 6)

                def fwd(turns=None):
                    return pt.launch_forward(x, oa, ob, None, geom, 2 * c,
                                             turns=turns)
                first, y = fwd()
                again, y2 = fwd()
                torch.cuda.synchronize()
                if not (torch.equal(first, again) and torch.equal(y, y2)
                        and torch.equal(first, got)):
                    raise AssertionError(f"train pair {label} C={c}: two "
                                         "forward launches differ")
                row["ms"] = cuda_time_ms(lambda: fwd(), iters=20)
                row["turns"] = pt.forward_turns(64, c, 6, 2 * c)
                if not row["turns"]:
                    with_turns = fwd(True)[0]
                    torch.cuda.synchronize()
                    if not torch.equal(with_turns, first):
                        raise AssertionError("the train pair with turns "
                                             "differs")
                    row["ms_with_turns"] = cuda_time_ms(
                        lambda: fwd(True), iters=20)
                kpc = _kernels_per_call(lambda: fwd())
                row["fwd_kernels_per_call"] = kpc["kernels"]
                if kpc["kernels"] not in (0, 1) or any(
                        "pair_train_fwd_kernel" not in k
                        for k in kpc["names"]):
                    raise AssertionError(f"the train-pair forward launches "
                                         f"{kpc}")
                row["forward_phases_ms"] = _phase_ms(
                    lambda: fwd(), phases=TRAIN_FWD_PHASES)
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

                def staged():  # block b's staged VJP, then block a's
                    ya = bt.block_train_reference(x, pa, ba, None,
                                                  num_heads=6,
                                                  softmax=softmax)
                    y2 = shift_relayout(ya, (24, 24), 8, 4)
                    dxb, gb, dbb = bt.block_bwd_reference(
                        y2, dz, pb, bb, None, num_heads=6, softmax=softmax)
                    dy = unshift_relayout(dxb, (24, 24), 8, 4)
                    dxa, ga, dba = bt.block_bwd_reference(
                        x, dy, pa, ba, None, num_heads=6, softmax=softmax)
                    return dxa, ga, dba, gb, dbb

                row.update(_backward_extras(
                    f"{label} C={c}", lambda: pt.launch_backward(
                        x, dz, y, pa, ba, pb, bb, None, geom),
                    pt.launch_backward, 2, staged))
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
                fp = row["forward_phases_ms"]
                log(f"  {label} C={c}: forward {row['ms']:.4f} ms (turns "
                    f"{row['turns']}"
                    + (f"; with turns {row['ms_with_turns']:.4f} ms, bitwise"
                       " the same" if "ms_with_turns" in row else "")
                    + f"; plain {row['plain_ms']:.4f}, bound "
                    f"{row['bound_ms']:.4f} {row['bound_by']}); two launches "
                    f"bitwise equal; {kpc['kernels']} kernel a call "
                    f"({kpc['events']:g} events recorded a call); device "
                    + (", ".join(f"{k} {v:.4f} ms" for k, v in fp.items())
                       if fp else "not measured")
                    + f"; backward {row['bwd_ms']:.4f} ms (plain "
                    f"{row['plain_bwd_ms']:.4f}, bound "
                    f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
            rows.append(row)
    return rows


@phase("train-pair kernels vs plain")
def train_kernel_phase(model) -> dict:
    """Forward and backward kernels against the plain version and its
    autograd gradient, at the training geometry of the flagship (C = 60 /
    90 / 120); the forward's ptxas report."""
    rows = _train_pair_widths(model, ((0, 60), (1, 90), (2, 120)), "E1")
    ptxas = _ptxas_check("pair_train.cu", "pair_train_fwd_kernel")
    timed = [r for r in rows if "ms" in r]
    mean = sum(r["ms"] for r in timed) / len(timed)
    log(f"train-pair forward, mean over C = 60/90/120 at 288 windows: "
        f"{mean:.4f} ms; library yardstick: no single PyTorch call computes "
        "a DSTL pair or its gradient")
    return {"variants": rows, "ptxas": ptxas, "forward_mean_ms": mean}


def _train_argv(data_dir: str, out_dir: str, steps: int,
                config: str = TRAIN_CONFIG) -> list:
    return ["--config-file", config,
            f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
            f"epochs_in_total={{'WarmUP': {steps}}}",
            f"check_every={TRAIN_CHECK}", "quick_eva_num_samples=8",
            "verbose=False"]


def _first_step_vs_plain(probe, batch, ts: str = "WarmUP") -> dict:
    """The first step (``train_step``: in a GAN state the discriminator's
    update, then the generator's) on the kernel route against the plain
    bf16 route (``set_train_mode(model, '')``), from the same parameters,
    optimizer and discriminator states, batch and stochastic-depth draws:
    the kernel route's factor columns take the generator's numbers in the
    order the plain route's DropPath layers take them. The generator's
    gradient is read from its fresh optimizer's first moment, (1 - b1) g.
    Loss and every reported term rtol TRAIN_LOSS_RTOL, gradients relative
    max < TRAIN_GRAD_TOL; leaves the probe on the plain route."""
    import copy

    from rdst_tpu_torch.models.routes import set_train_mode

    opt, adv = probe.opt, probe.loss.adversarial
    if opt.count:
        raise AssertionError("the probe's optimizer has stepped already")
    saved = copy.deepcopy({
        "model": probe.model.state_dict(), "opt": opt.state_dict(),
        "adv": adv.state_dict() if adv is not None else None,
        "gen": probe.generator.get_state()})

    def step():
        total, rep, ok = probe.train_step(batch, ts)
        grads = (opt.state["mu"] / (1.0 - opt.b1)).split(opt.numels)
        return (float(total), {k: float(v) for k, v in rep.items()},
                [g.clone() for g in grads], bool(ok))

    loss_k, rep_k, g_k, ok_k = step()
    probe.model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["opt"])
    if adv is not None:
        adv.load_state_dict(saved["adv"])
    probe.generator.set_state(saved["gen"])
    set_train_mode(probe.model, "")
    loss_p, rep_p, g_p, ok_p = step()
    gmax = max(float(g.abs().max()) for g in g_p)
    rel = max(float((a - b).abs().max())
              / max(1e-5, float(b.abs().max()), 0.12 * gmax)
              for a, b in zip(g_k, g_p))
    log(f"first step: loss kernel route {loss_k:.6f} vs plain bf16 route "
        f"{loss_p:.6f} (rtol {TRAIN_LOSS_RTOL}); "
        + "".join(f"{k} {rep_k[k]:.6f} / {rep_p[k]:.6f}; " for k in rep_p)
        + f"gradients rel max {rel:.4f} (bar {TRAIN_GRAD_TOL})")
    if not (ok_k and ok_p) or rep_k.keys() != rep_p.keys() or any(
            abs(u - v) > TRAIN_LOSS_RTOL * abs(v)
            for u, v in [(loss_k, loss_p)]
            + [(rep_k[k], rep_p[k]) for k in rep_p]) or \
            rel >= TRAIN_GRAD_TOL:
        raise AssertionError("kernel route vs plain route on the first step")
    return {"first_loss_kernel": loss_k, "first_loss_plain": loss_p,
            "first_grad_rel_max": rel, "first_report_kernel": rep_k,
            "first_report_plain": rep_p}


def _serve_snapshot(config: str, trainer, **overrides) -> str:
    """The run's last snapshot served by ``LiveModel`` on the card (the
    config with ``overrides``): finite, of the x4 shape, on a validation
    LR slice; returns the snapshot's path."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import LiveModel

    snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
    paras = ParametersLoader(config)
    paras.set("well_trained_single_scale_model_g", snap)
    for k, v in overrides.items():
        paras.set(k, v)
    live = LiveModel(paras, max_batch=1, device="cuda")
    lr = trainer.ds_valid.get_test_pair(0)[4.0]["in"]
    y = live.predict(lr, SCALE)
    if not np.isfinite(y).all() or y.shape[1:3] != (lr.shape[1] * 4,
                                                     lr.shape[2] * 4):
        raise AssertionError(f"served {y.shape}")
    log(f"the snapshot ({os.path.getsize(snap)} bytes) served by LiveModel "
        f"({live.manifest['dtype']}, routes {live.manifest['routes'][:1]}..., "
        f"int8 {live.manifest['pallas_quant']}): {lr.shape} -> {y.shape}")
    return snap


def _make_corpus(tmp: str) -> str:
    """The 20-phantom corpus the port's generator makes from seed 0."""
    from rdst_tpu_torch.data import synthetic

    data_dir = os.path.join(tmp, "OASIS", "example20")
    t0 = time.perf_counter()
    synthetic.make_oasis_example(
        data_dir, patient_ids=tuple(f"OAS1_{i:04d}_MR1" for i in range(1, 21)))
    log(f"generated the 20-phantom corpus in "
        f"{time.perf_counter() - t0:.3f} s")
    return data_dir


@phase("bf16 training step")
def train_phase(data_dir: str, tmp: str) -> dict:
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import pair_train as pt

    out = {}

    # the first step's loss and gradients, kernel route vs plain route,
    # from the run's own initial parameters (same seed) and first batch
    probe = build_trainer(_train_argv(data_dir, os.path.join(tmp, "probe"),
                                      1))
    probe.setup()
    # the run below starts from these parameters (same seed, same init)
    init = {k: v.clone() for k, v in probe.model.state_dict().items()}
    batch = probe.ds_train.sample(np.random.default_rng(17))
    if probe.model.train_mode != "pair" or \
            probe.model.train_routes != {"pair": 24, "block": 0}:
        raise AssertionError(f"train route {probe.model.train_mode} "
                             f"{probe.model.train_routes}")
    out["train_routes"] = dict(probe.model.train_routes)
    log(f"train routes {probe.model.train_routes}")
    out.update(_first_step_vs_plain(probe, batch))
    del probe

    out_dir = os.path.join(tmp, "outputs")
    from rdst_tpu_torch.kernels import block_train as bt
    bt.launch_forward.launches = bt.launch_backward.launches = 0
    pt.launch_forward.launches = pt.launch_backward.launches = 0  # main path
    pt.launch_backward.reductions = 0
    t0 = time.perf_counter()
    trainer = train_main(_train_argv(data_dir, out_dir, TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches
    out.update(forward_launches=fwd, backward_launches=bwd,
               reduction_launches=pt.launch_backward.reductions)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): train-pair launches forward {fwd}, backward {bwd} "
        f"(+{pt.launch_backward.reductions} kernels beside the attention "
        "VJPs)")
    if fwd != 24 * TRAIN_STEPS or bwd != 24 * TRAIN_STEPS or \
            bt.launch_forward.launches or bt.launch_backward.launches:
        raise AssertionError(f"expected {24 * TRAIN_STEPS} forward and "
                             "backward launches (24 DSTL pairs a step) and "
                             "no single-block train launch")
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
    _serve_snapshot(TRAIN_CONFIG, trainer)
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


def _step_profile(trainer, ts: str = "WarmUP", seed: int = SEED + 6,
                  label: str = "training step") -> dict:
    """Steps/s over WALL_STEPS warm steps of one batch on the wall clock;
    the device time of one profiled step by kernel group, and the
    device's idle share of the step's wall time; in a GAN state, the
    device time of the discriminator's update alone (the generator
    forward without gradient and ``d_step``, on the same batch) and its
    share of the step's."""
    from torch.autograd import DeviceType

    from rdst_tpu_torch.runners.trainer import pin_batch

    batch = pin_batch(trainer.ds_train.sample(np.random.default_rng(seed)))
    trainer.train_step(batch, ts)
    torch.cuda.synchronize()
    # steps/s on the wall clock: WALL_STEPS steps queued back to back, as
    # the training loop queues them, then one wait for the card
    t0 = time.perf_counter()
    for _ in range(WALL_STEPS):
        trainer.train_step(batch, ts)
    torch.cuda.synchronize()
    steps_per_s = WALL_STEPS / (time.perf_counter() - t0)
    log(f"{label}: {steps_per_s:.3f} steps/s over {WALL_STEPS} warm steps "
        "(wall clock, one batch)")
    wall_us, events, device = _profiled(lambda: trainer.train_step(batch, ts))
    groups = {"train kernels forward": 0.0,
              "train kernels backward (13 kernels a block)": 0.0,
              "convolution": 0.0, "matmul (adapters, optimizer)": 0.0,
              "other (LayerNorms, casts, elementwise)": 0.0}
    top = []
    for e in device:
        t = float(e.self_device_time_total or 0.0)
        if t <= 0:
            continue
        name = e.key.lower()
        if ("pair_train_fwd" in name or "tokwg::" in name
                or "tokfwd::" in name):
            # the train pair's forward; the block-train forward's GEMMs and
            # LN1 rows (csrc/token_fwd.cuh)
            groups["train kernels forward"] += t
        elif "attn_fwd_kernel<false>" in name:
            # the block-train forward's attention and the backward's
            # recompute: one launch each a block, on the same shapes
            groups["train kernels forward"] += t / 2
            groups["train kernels backward (13 kernels a block)"] += t / 2
        elif "trainblk::" in name or "tokpar::" in name:
            # the backward's own kernels and those it shares with the
            # serving forward (csrc/token_gemm.cuh)
            groups["train kernels backward (13 kernels a block)"] += t
        elif any(w in name for w in CONV_KERNELS + ("wgrad", "dgrad")):
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
    # kernels the step launches (memory sets and copies apart)
    launches = sum(e.count for e in device
                   if "memset" not in e.key.lower()
                   and "memcpy" not in e.key.lower())
    out = {"steps_per_s": steps_per_s, "wall_us": wall_us,
           "device_us": busy, "groups_us": groups,
           "top": sorted(top, reverse=True)[:12], "host_top": cpu[:12],
           "host_ops": sum(n for _, n, _ in cpu),
           "kernel_launches": launches}
    if busy == 0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return out
    out["idle_share"] = 1.0 - busy / wall_us
    log(f"{label} under the profiler: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms, idle share {out['idle_share']:.3f}, "
        f"{launches} kernel launches")
    for name, t in groups.items():
        log(f"  {name}: {t / 1e3:.3f} ms ({100 * t / busy:.1f} % of device "
            "time)")
    for t, count, key in out["top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:4d} {key}")
    log(f"host: {out['host_ops']} profiled CPU ops; by self CPU time "
        "(the profiler's own overhead included):")
    for t, count, key in out["host_top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:5d} {key}")
    adv = trainer.loss.adversarial
    if adv is not None and trainer.gan_active(ts):
        x = torch.as_tensor(batch["in"]).to(trainer.device)
        db = trainer.device_batch(batch)

        def d_update():
            with torch.no_grad():
                fake = trainer.model(x).float()
            adv.d_step(fake, db["out"], db["sr_scales"], trainer.generator)

        d_busy = _device_ms(d_update)[1] * 1e3
        out.update(d_update_us=d_busy, d_update_share=d_busy / busy)
        log(f"  D update (no-grad generator forward + d_step): "
            f"{d_busy / 1e3:.3f} ms = {d_busy / busy:.3f} of the step's "
            "device time")
    return out


train_profile_phase = phase("training profile")(_step_profile)


# ---------------------------------------------------------------------------
# The fine-tune recipes: the seg-UNet perceptual loss and the RaGAN
# discriminator, in f32 as shipped and in bf16 on the train-pair kernels
# ---------------------------------------------------------------------------

E1_RECIPE_CONFIG = "config_files/rdst_e1_oasis_x4.ini"
# the committed seg UNet (a full-width SegUNet(1, 4)), which the seg
# recipes name in place of their random UNet
UNET_CKPT = "weights/unet_tiny.pkl"
FT_STEPS, FT_CHECK, FT_BF16_STEPS = 12, 6, 6
# FID of the same images on the card against the CPU: f32 features on both
# sides (TF32 off), the Frechet distance in float64 on the host
FID_RTOL = 1e-3


def _card_line() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {line}")
    return line


def _ft_argv(config: str, data_dir: str, out_dir: str, epochs: dict,
             check: int = FT_CHECK, seg: bool = False, **over) -> list:
    """A shipped config with only the paths, the steps and the check
    interval overridden (and ``over``); a recipe with the UNet-F term
    names the committed seg UNet (``--seg-loss`` adds the segmentation
    labels)."""
    argv = ["--config-file", config] + (["--seg-loss"] if seg else [])
    argv += [f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
             f"epochs_in_total={epochs!r}", f"check_every={check}",
             "verbose=False"]
    if config in (HRL_CONFIG, E1_RECIPE_CONFIG):
        over = {"unet_native_ckpt": UNET_CKPT, **over}
    return argv + [f"{k}={v!r}" for k, v in over.items()]


def _committed_unet(trainer) -> None:
    """The UNet-F term scores with the committed seg UNet's weights."""
    import pickle

    with open(UNET_CKPT, "rb") as f:
        want = pickle.load(f)["params"]["encoder"]["conv1"]["kernel"]
    got = trainer.loss.terms["UNet-F"].model.encoder.conv1.weight
    if not np.array_equal(got.detach().cpu().numpy(),
                          np.transpose(want, (3, 2, 0, 1))):
        raise AssertionError(f"the UNet-F term does not use {UNET_CKPT}")


def _f32_forwards(label: str) -> int:
    """The f32 block kernel's launches since the last reset, as whole
    E1 forwards (48 blocks each)."""
    from rdst_tpu_torch.kernels import swin_block

    n = swin_block.fused_swin_block.launches
    if n <= 0 or n % 48:
        raise AssertionError(f"{label}: {n} f32 block launches, not a "
                             "positive multiple of 48")
    return n // 48


def _ft_records(trainer, ts: str, names) -> dict:
    rec = trainer.loss.records.get(ts, {})
    for n in names:
        v = rec.get(n) or []
        if not v or not np.isfinite(v).all():
            raise AssertionError(f"{ts} record {n}: {v}")
    return {n: list(rec[n]) for n in names}


def _snapshots(trainer, names) -> dict:
    out = {}
    for n in names:
        path = os.path.join(trainer.dirs["models"], n)
        if not os.path.isfile(path):
            raise AssertionError(f"missing snapshot {path}")
        out[n] = os.path.getsize(path)
    log(f"snapshots {out} (bytes)")
    return out


def _fid_card_vs_cpu(trainer) -> dict:
    """FID of the final evaluation's images (every validation slice, the
    largest scale) on the card and on the CPU, timed."""
    from rdst_tpu_torch.metrics.fid import FID

    recs, pairs = trainer._infer_pairs(
        list(range(trainer.ds_valid.test_len())))
    s = sorted(pairs[0])[-1]
    gts = [p[s]["gt"] for p in pairs]
    preds = [r[s] for r in recs]
    out = {}
    for name, gpu in (("card", 0), ("cpu", -1)):
        fid = FID(gpu_id=gpu)
        fid(gts[:2], preds[:2])  # the extractor built and warm
        if gpu >= 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fid(gts, preds)
        if gpu >= 0:
            torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
    rel = abs(out["card"] - out["cpu"]) / max(abs(out["cpu"]), 1e-12)
    out.update(images=len(gts), rel=rel)
    log(f"FID of {len(gts)} validation slices (VGG substitute features): "
        f"card {out['card']:.6f} in {out['card_s']:.3f} s, CPU "
        f"{out['cpu']:.6f} in {out['cpu_s']:.3f} s, relative difference "
        f"{rel:.2e} (bar {FID_RTOL})")
    if not np.isfinite(out["card"]) or rel > FID_RTOL:
        raise AssertionError("FID on the card vs on the CPU")
    return out


@phase("seg fine-tune")
def seg_finetune_phase(data_dir: str, tmp: str) -> dict:
    """``config_files/rdst_hrl_seg_ft_oasis20_x4.ini`` with ``--seg-loss``
    (warm start from the 40k E1 weights, L1 + UNet-F, f32 as shipped) for
    FT_STEPS steps with a quick evaluation every FT_CHECK; then the repo's
    example recipe ``config_files/rdst_e1_oasis_x4.ini`` (WarmUP -> UNet-F
    from scratch) for 3 steps a state on the same corpus (its patients 1-4
    are the corpus's first four)."""
    from rdst_tpu_torch.cli import train_main
    from rdst_tpu_torch.kernels import swin_block

    out = {"card": _card_line()}
    swin_block.fused_swin_block.launches = 0
    t0 = time.perf_counter()
    trainer = train_main(_ft_argv(HRL_CONFIG, data_dir,
                                  os.path.join(tmp, "seg_ft"),
                                  {"UNet-F": FT_STEPS}, seg=True))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["f32_forwards"] = _f32_forwards("seg fine-tune")
    _committed_unet(trainer)
    rec = _ft_records(trainer, "UNet-F", ("L1", "UNet-F"))
    if len(rec["UNet-F"]) != FT_STEPS or min(rec["UNet-F"]) <= 0:
        raise AssertionError(f"UNet-F records {rec['UNet-F']}")
    unet = trainer.loss.terms["UNet-F"]
    log(f"{FT_STEPS} steps in {out['run_s']:.3f} s (evaluations included): "
        f"UNet-F {rec['UNet-F'][0]:.6f} -> {rec['UNet-F'][-1]:.6f}, L1 "
        f"{rec['L1'][0]:.6f} -> {rec['L1'][-1]:.6f}; mode {unet.loss_mode} "
        f"{unet.loss_layers}; {out['f32_forwards']} f32 forwards "
        f"({48 * out['f32_forwards']} f32 block launches: the quick and "
        "final evaluations)")
    out["records"] = rec
    out["snapshots"] = _snapshots(trainer, ["UNet-F_model_g.msgpack"])
    out["profile"] = _step_profile(trainer, "UNet-F", SEED + 7,
                                   "E1 seg step (f32)")
    del trainer

    t0 = time.perf_counter()
    recipe = train_main(_ft_argv(E1_RECIPE_CONFIG, data_dir,
                                 os.path.join(tmp, "e1_recipe"),
                                 {"WarmUP": 3, "UNet-F": 3}, check=3))
    torch.cuda.synchronize()
    _committed_unet(recipe)
    warm = _ft_records(recipe, "WarmUP", ("L1",))
    seg = _ft_records(recipe, "UNet-F", ("L1", "UNet-F"))
    if "UNet-F" in recipe.loss.records["WarmUP"] or \
            len(warm["L1"]) != 3 or len(seg["UNet-F"]) != 3:
        raise AssertionError(f"recipe records {recipe.loss.records}")
    out["recipe"] = {"s": time.perf_counter() - t0, "WarmUP": warm,
                     "UNet-F": seg, "snapshots": _snapshots(
                         recipe, ["WarmUP_model_g.msgpack",
                                  "UNet-F_model_g.msgpack"])}
    log(f"{E1_RECIPE_CONFIG}: WarmUP L1 {warm['L1']}, then UNet-F L1 "
        f"{seg['L1']} UNet-F {seg['UNet-F']} in {out['recipe']['s']:.3f} s")
    return out


@phase("GAN fine-tune")
def gan_finetune_phase(data_dir: str, tmp: str) -> dict:
    """``config_files/rdst_gan_ft_oasis20_x4.ini`` (RaGAN, warm start from
    the 40k E1 weights, f32 as shipped, ``eva_metrics`` with FID) for
    FT_STEPS steps with a quick evaluation every FT_CHECK; the resume for 2
    more steps; the final evaluation's FID on the card against the CPU."""
    from rdst_tpu_torch.cli import train_main
    from rdst_tpu_torch.kernels import swin_block

    out = {"card": _card_line()}
    out_dir = os.path.join(tmp, "gan_ft")

    def argv(steps):
        return _ft_argv(GAN_CONFIG, data_dir, out_dir, {"GAN-FT": steps})

    swin_block.fused_swin_block.launches = 0
    t0 = time.perf_counter()
    trainer = train_main(argv(FT_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["f32_forwards"] = _f32_forwards("GAN fine-tune")
    rec = _ft_records(trainer, "GAN-FT",
                      ("L1", "GAN", "Adv_D", "Adv_D Real", "Adv_D Fake"))
    if len(rec["Adv_D"]) != FT_STEPS or len(set(rec["Adv_D"])) < 2:
        raise AssertionError(f"the discriminator's loss {rec['Adv_D']}")
    adv = trainer.loss.adversarial
    log(f"{FT_STEPS} steps in {out['run_s']:.3f} s (evaluations included): "
        f"L1 {rec['L1'][0]:.6f} -> {rec['L1'][-1]:.6f}, GAN "
        f"{rec['GAN'][0]:.6f} -> {rec['GAN'][-1]:.6f}, Adv_D "
        f"{rec['Adv_D'][0]:.6f} -> {rec['Adv_D'][-1]:.6f} (real "
        f"{rec['Adv_D Real'][-1]:.6f}, fake {rec['Adv_D Fake'][-1]:.6f}); "
        f"D {type(adv.discriminator).__name__} "
        f"{sum(p.numel() for p in adv.params)} parameters, {adv.opt.count} "
        f"updates; {out['f32_forwards']} f32 forwards")
    out["records"] = rec
    out["snapshots"] = _snapshots(trainer, ["GAN-FT_model_g.msgpack",
                                            "GAN-FT_loss_d.msgpack"])
    del trainer
    resumed = train_main(argv(FT_STEPS + 2))
    with open(resumed.log_file) as f:
        if f"Resumed from checkpoint: state_id=0 epoch={FT_STEPS}" \
                not in f.read() or resumed.step != FT_STEPS + 2:
            raise AssertionError(f"resume: step {resumed.step}")
    log(f"resumed from the step-{FT_STEPS} checkpoint to step "
        f"{resumed.step} (D updates {resumed.loss.adversarial.opt.count})")
    out["fid"] = _fid_card_vs_cpu(resumed)
    out["profile"] = _step_profile(resumed, "GAN-FT", SEED + 7,
                                   "E1 GAN step (f32)")
    return out


@phase("fine-tune bf16")
def finetune_bf16_phase(data_dir: str, tmp: str) -> dict:
    """Both recipes with ``training_dtype='bfloat16'`` for FT_BF16_STEPS
    steps: every DSTL pair on the train-pair kernels (24 pairs), 24
    backward calls a step and 24 forward calls a generator forward (the
    seg step runs one, the GAN step two: the discriminator's fakes without
    gradient, then the step); the first step's losses against the plain
    bf16 route."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt

    out = {"card": _card_line()}
    for label, config, ts, seg, forwards in (
            ("seg", HRL_CONFIG, "UNet-F", True, 1),
            ("GAN", GAN_CONFIG, "GAN-FT", False, 2)):
        def argv(sub, steps):
            return _ft_argv(config, data_dir,
                            os.path.join(tmp, f"{label}_bf16_{sub}"),
                            {ts: steps}, check=FT_BF16_STEPS, seg=seg,
                            training_dtype="bfloat16")

        probe = build_trainer(argv("probe", 1))
        probe.setup()
        if seg:
            _committed_unet(probe)
        routes = dict(probe.model.train_routes)
        if probe.model.train_mode != "pair" or routes != {"pair": 24,
                                                          "block": 0}:
            raise AssertionError(f"{label}: train routes {routes}")
        batch = probe.ds_train.sample(np.random.default_rng(SEED + 8))
        res = {"train_routes": routes,
               "first_step": _first_step_vs_plain(probe, batch, ts)}
        del probe
        bt.launch_forward.launches = bt.launch_backward.launches = 0
        pt.launch_forward.launches = pt.launch_backward.launches = 0
        t0 = time.perf_counter()
        trainer = train_main(argv("run", FT_BF16_STEPS))
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches
        res.update(forward_launches=fwd, backward_launches=bwd)
        log(f"{label} bf16: {FT_BF16_STEPS} steps in {res['run_s']:.3f} s "
            f"(evaluations included): train-pair launches forward {fwd}, "
            f"backward {bwd}")
        if fwd != 24 * forwards * FT_BF16_STEPS or \
                bwd != 24 * FT_BF16_STEPS or bt.launch_forward.launches or \
                bt.launch_backward.launches:
            raise AssertionError(
                f"{label}: expected {24 * forwards} forward and 24 backward "
                "train-pair launches a step and no single-block train launch")
        names = ("L1", "UNet-F") if seg else ("L1", "GAN", "Adv_D")
        res["records"] = _ft_records(trainer, ts, names)
        res["profile"] = _step_profile(trainer, ts, SEED + 7,
                                       f"E1 {label} step (bf16)")
        out[label] = res
        del trainer
    return out


# ---------------------------------------------------------------------------
# SwinIR-std x4 (C = 180): the widened fast block with int8 qkv, the
# single-block train kernels, serving and training
# ---------------------------------------------------------------------------

SWINIR_CONFIG = "config_files/swinir_std_40k_oasis20_x4.ini"
SWINIR_WEIGHTS = "weights/swinir_std_40k_best_oasis20_x4.msgpack"
SWINIR_TRAIN_CONFIG = "config_files/swinir_std_100k_oasis20_x4.ini"
INT8_OPS = 1979e12  # dense int8 tensor-core peak (H100 SXM data sheet)


def _int8_qkv_bound(tokens: int, c: int, nbytes: float, n: int = 64):
    """Bound of a fast-block launch with int8 qkv: the qkv product (6C^2
    ops per token) at the int8 peak, the rest (10C^2 + 4NC) at the bf16
    peak."""
    t_ops = tokens * (6 * c * c / INT8_OPS + (10 * c * c + 4 * n * c)
                      / BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@phase("SwinIR-std bf16 kernels vs plain")
def swinir_kernel_phase(model) -> dict:
    """The fast block at C = 180 with int8 qkv, the launch alone (weights
    prepared once, as the model keeps them) against its plain version at
    bucket 64 (1280 windows), with the committed SwinIR-std weights: the
    path's unshifted block (shared bias), and a shifted case (the second
    block's weights at shift 4, per-window bias), under 'clamp' (the
    checkpoint's resolved variant) and 'stable_bc'."""
    from rdst_tpu_torch.kernels import swin_block

    ws, nw, images, nh, c = 8, 20, 64, 6, 180
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    quant = frozenset({"qkv"})
    tok_kernels = swin_block.kernels_per_call(
        "swin_block_fast.cu", "swin_block_fast_tokens_kernels")
    rows = []
    for k, shift in enumerate((0, ws // 2)):
        blk = model.layers[0].residual_group.blocks[k]
        inputs = blk.fast_kernel_inputs(LR_HW, ws, shift)
        plan = swin_block.plan_fast_block(*inputs, num_heads=nh, quant=quant)
        if plan.route != "tokens":
            raise AssertionError(f"C={c} planned for {plan.route}")
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        for softmax in ("clamp", "stable_bc"):
            kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
            with torch.inference_mode():
                got = swin_block.run_fast_block(x, plan, **kw)
                want = swin_block.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh,
                    softmax=softmax, qkv=plan.qkv)
                torch.cuda.synchronize()
                err = _check(f"fast block C={c} shift={shift} int8 qkv "
                             f"{softmax}", got, want)

                def call():
                    return swin_block.run_fast_block(x, plan, **kw)

                ms = cuda_time_ms(call)
                plain_ms = cuda_time_ms(
                    lambda: swin_block.swin_block_fast_reference(
                        x, plan.params, plan.bias, num_heads=nh,
                        softmax=softmax, qkv=plan.qkv), warmup=1, iters=5)
                flops = _block_flops(images * nw, c)
                extras = _forward_extras(
                    f"fast block C={c} shift={shift} {softmax} (tokens)",
                    call, tok_kernels, FAST_PHASES, flops)
            nbytes = 2 * 2 * x.numel() + _plan_bytes(plan) + sum(
                t.numel() * t.element_size() for t in plan.qkv_layout)
            bound_ms, by = _int8_qkv_bound(x.shape[0] * 64, c, nbytes)
            rows.append(dict(c=c, shift=shift, softmax=softmax,
                             rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=by, **extras))
            log(f"fast block C={c} shift={shift} int8 qkv {softmax:9s}: rel "
                f"max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}) kernel "
                f"(tokens) {ms:.4f} ms; plain {plain_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({by}; {flops / ms / 1e9:.1f} TFLOP/s of "
                "block work)")
    log("library yardstick: no single PyTorch call computes a Swin block")
    return {"variants": rows}


@phase("SwinIR-std bf16 whole model")
def swinir_model_phase(live16, live32, live_cpu) -> dict:
    """36 fast-block launches per forward (every RSTB block, none shifted);
    the card against the same model on the CPU, where the wrapper takes
    its plain version (bf16 + int8, bar BF16_TOL); and against the plain
    f32 path (``pallas_kernels='off'``): relative error and PSNR."""
    from rdst_tpu_torch.kernels import swin_block

    rng = np.random.default_rng(SEED + 8)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    y_cpu = live_cpu.predict(x, SCALE)
    y32 = live32.predict(x, SCALE)
    swin_block.run_fast_block.launches = 0  # the path starts here
    y = live16.predict(x, SCALE)
    launches = swin_block.run_fast_block.launches  # and ends here
    if launches != 36:
        raise AssertionError(f"{launches} fast-block launches per forward, "
                             "expected 36 (6 RSTBs x 6 blocks)")
    if not np.isfinite(y).all() or y.shape != (8, 160, 128, 1):
        raise AssertionError(f"output {y.shape}")

    def versus(a, ref):
        r = _rel(torch.from_numpy(a), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((a - ref) ** 2)))

    kp, kf = versus(y, y_cpu), versus(y, y32)
    log(f"SwinIR-std bf16 + int8 qkv: {launches} launches of run_fast_block "
        f"per forward; vs its plain versions (the CPU run) rel max "
        f"{kp[0]:.3e} (bar {BF16_TOL}); vs the plain f32 path rel max "
        f"{kf[0]:.3e} mean {kf[1]:.3e}, PSNR {kf[2]:.2f} dB")
    if kp[0] > BF16_TOL:
        raise AssertionError(f"vs plain versions: {kp}")
    if kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"vs f32: {kf}")
    return {"launches_per_forward": launches,
            "vs_plain_versions_rel_max": kp[0], "vs_f32_rel_max": kf[0],
            "vs_f32_rel_mean": kf[1], "psnr_vs_f32_db": kf[2]}


swinir_serving_phase = phase("SwinIR-std bf16 serving")(_serve)
swinir_profile_phase = phase("SwinIR-std bf16 profile")(_profile)


def _block_train_case(blk, c: int, shift: int, gen):
    """A block at the training geometry (32 images of 24x24, 288
    windows): its raw 12 parameters and head-major bias (shift 4: rel-pos
    + mask per window), bf16 tokens, cotangents and factor columns."""
    params, bias = blk.fast_kernel_inputs((24, 24), 8, shift)
    ops = [p.detach().float().contiguous() for p in params] + \
        [bias.detach().float().contiguous()]
    x = torch.randn(288, 64, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    dz = torch.randn(288, 64, c, device="cuda",
                     generator=gen).to(torch.bfloat16)
    keep = 0.9
    cols = (torch.rand(32, 2, device="cuda", generator=gen) < keep)
    dpf = (cols.float() / keep).repeat_interleave(9 * 64, 0).contiguous()
    return ops, x, dz, dpf


def _block_train_grads(kernel: bool, ops, x, dz, dpf, softmax, nh=6):
    """Output and gradients (x, the 12 raw parameters, the head-major
    bias) of the block through the fold, on the kernels or the plain
    version."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels.swin_block import fast_params, pack_bias_fast

    c = x.shape[-1]
    leaves = [t.detach().clone().requires_grad_(True) for t in [x] + ops]
    p, bias = leaves[1:13], leaves[13]
    fp, pb = fast_params(p, c, nh), pack_bias_fast(bias.to(torch.bfloat16),
                                                   nh, 64)
    if kernel:
        out = bt.run_block_train(leaves[0], fp, pb, dpf, num_heads=nh,
                                 windows_per_image=9, softmax=softmax)
    else:
        out = bt.block_train_reference(leaves[0], fp, pb, dpf, num_heads=nh,
                                       softmax=softmax)
    out.backward(dz)
    return out.detach(), [t.grad for t in leaves]


BLOCK_TRAIN_NAMES = ["x", "wqkv", "bqkv", "wproj", "bproj", "g1", "b1", "g2",
                     "b2", "w1", "bf1", "w2", "bf2", "bias"]


def _block_train_variant(label: str, ops, x, dz, dpf, softmax: str,
                         nh: int = 6) -> dict:
    """The kernels' output and every gradient against the plain version
    and its autograd, bar BF16_TOL."""
    got, g_got = _block_train_grads(True, ops, x, dz, dpf, softmax, nh)
    want, g_want = _block_train_grads(False, ops, x, dz, dpf, softmax, nh)
    torch.cuda.synchronize()
    errs = {"out": _rel(got, want)}
    for nm, a, b in zip(BLOCK_TRAIN_NAMES, g_got, g_want):
        if float(b.abs().max()) > 0:
            errs[nm] = _rel(a, b)
        elif float(a.abs().max()) > 0:
            errs[nm] = (float("inf"), float("inf"), float(a.abs().max()))
    worst = max(errs, key=lambda e: errs[e][0])
    finite = all(bool(torch.isfinite(g).all()) for g in g_got) \
        and bool(torch.isfinite(got.float()).all())
    log(f"{label}: out rel max {errs['out'][0]:.3e}, dx "
        f"{errs['x'][0]:.3e}, worst {worst} {errs[worst][0]:.3e} (bar "
        f"{BF16_TOL})")
    if not finite or errs[worst][0] > BF16_TOL:
        raise AssertionError(f"{label}: {errs}")
    return dict(rel_max={e: v[0] for e, v in errs.items()},
                out_abs_err=errs["out"][2],
                grad_abs_err=max(v[2] for e, v in errs.items()
                                 if e != "out"))


def _block_train_forward_times(x, ops, softmax: str, nh: int = 6) -> dict:
    """The forward launch alone (weights laid out once): its time, the
    plain time and the bound."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels.swin_block import (fast_params,
                                                   pack_bias_fast,
                                                   softmax_code)

    c = x.shape[-1]
    with torch.no_grad():
        fp = fast_params(ops[:12], c, nh)
        pb = pack_bias_fast(ops[12].to(torch.bfloat16), nh, 64)
        layout = bt.forward_layout(fp, nh)
    code = softmax_code(softmax)
    hidden = fp.w1.shape[1]
    out = {"ms": cuda_time_ms(lambda: bt.launch_forward(
        x, layout, pb, None, nh, hidden, code), iters=10)}
    with torch.no_grad():
        out["plain_ms"] = cuda_time_ms(lambda: bt.block_train_reference(
            x, fp, pb, None, num_heads=nh, softmax=softmax))
    wbytes = sum(t.numel() * t.element_size() for t in [*fp, pb])
    out["bound_ms"], out["bound_by"] = _bound(
        _block_flops(x.shape[0], c), 2 * x.numel() * 2 + wbytes)
    return out, fp, pb, layout, code


def _tile_rows_times(gen) -> dict:
    """The block-train forward's GEMMs alone at its geometry (18,432
    tokens, C = 180) in tiles of 64 and of 128 rows: the data for the
    schedule's rule (``token_tile_rows``)."""
    from rdst_tpu_torch.kernels.swin_block import token_tile_rows

    t, c, nh, hidden = 288 * 64, 180, 6, 360
    o = _gemm_operands(gen, t, c, nh, hidden, GEMM_GROWTH)
    out = {}
    for bm in (64, 128):
        launches = _gemm_launches(o, c, hidden, bm)
        out[bm] = {k: cuda_time_ms(launches[k], iters=20)
                   for k in ("qkv bf16", "proj + LN2", "fc1 + fc2")}
    log(f"  tile rows at {t} tokens, C = {c} (ms; the schedule takes "
        f"{token_tile_rows(t)}):")
    for k in out[64]:
        log(f"    {k:11s} 64 rows {out[64][k]:.4f}, 128 rows "
            f"{out[128][k]:.4f}")
    return {str(bm): v for bm, v in out.items()}


@phase("block-train kernels vs plain")
def block_train_kernel_phase(model) -> dict:
    """``fused_swin_block_train``'s forward (the token-parallel forward,
    exact division, factor columns) and backward kernels against the plain
    version and its autograd gradient at 288 windows, C = 180, with the
    committed SwinIR-std weights: the path's unshifted block and a
    shifted case, with and without factor columns, 'clamp' and 'stable';
    the output and every gradient (x, the 12 parameters through the fold,
    the bias), bar BF16_TOL. The forward launch alone: two launches
    bitwise equal, kernels a call, device time by phase; its GEMMs in
    tiles of 64 and 128 rows; the ptxas report of its GEMM kernels. Then
    RDST-W96's block-train widths, C = 144 and 192, with its committed
    weights, as the training step's routes would send them."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels.swin_block import kernels_per_call

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    fwd_kernels = kernels_per_call("block_train.cu",
                                   "block_train_fwd_kernels")
    for k, shift in enumerate((0, 4)):
        blk = model.layers[0].residual_group.blocks[k]
        ops, x, dz, dpf0 = _block_train_case(blk, 180, shift, gen)
        for softmax in ("clamp", "stable"):
            for use_dpf in (False, True):
                dpf = dpf0 if use_dpf else None
                row = _block_train_variant(
                    f"block train C=180 shift={shift} {softmax:6s} "
                    f"dpf={use_dpf!s:5s}", ops, x, dz, dpf, softmax)
                rows.append(dict(shift=shift, softmax=softmax, dpf=use_dpf,
                                 **row))
        if shift == 0:  # the path's case: times of the launches alone
            softmax = "clamp"
            times, fp, pb, layout, code = _block_train_forward_times(
                x, ops, softmax)
            row = rows[-4]
            row.update(times)
            row["forward"] = _forward_extras(
                "block train forward C=180",
                lambda: bt.launch_forward(x, layout, pb, dpf0, 6, 360, code),
                fwd_kernels, FAST_PHASES, _block_flops(288, 180))
            row["bwd_ms"] = cuda_time_ms(lambda: bt.launch_backward(
                x, dz, fp, pb, None, 6, code), warmup=1, iters=5)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in [x, *fp, pb]]
            twin = bt.block_train_reference(
                leaves[0], type(fp)(*leaves[1:9]), leaves[9], None,
                num_heads=6, softmax=softmax)
            row["plain_bwd_ms"] = cuda_time_ms(
                lambda: torch.autograd.grad(twin, leaves, dz,
                                            retain_graph=True),
                warmup=1, iters=5)
            del twin, leaves
            row.update(_backward_extras(
                "C=180", lambda: bt.launch_backward(x, dz, fp, pb, None, 6,
                                                    code),
                bt.launch_backward, 1,
                lambda: bt.block_bwd_reference(x, dz, fp, pb, None,
                                               num_heads=6,
                                               softmax=softmax)))
            flops = _block_flops(288, 180)
            wbytes = sum(t.numel() * t.element_size() for t in [*fp, pb])
            tok = x.numel() * 2
            # backward: x, dz in, dx out, the weights in, f32 grads out
            row["bwd_bound_ms"], row["bwd_bound_by"] = _bound(
                2 * flops, 3 * tok + wbytes + 2 * wbytes)
            log(f"  C=180: forward {row['ms']:.4f} ms (plain "
                f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"{row['bound_by']}), backward {row['bwd_ms']:.4f} ms "
                f"(plain {row['plain_bwd_ms']:.4f}, bound "
                f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
    tiles = _tile_rows_times(gen)
    ptxas = _ptxas_check("block_train.cu", "tokwg")
    w96 = []
    w96_model = _build_f32(W96_CONFIG, W96_WEIGHTS)
    rdstb = w96_model.body[0]
    for j, c in ((1, 144), (2, 192)):
        for k, shift in enumerate((0, 4)):
            blk = rdstb.body[j].body.blocks[k]
            ops, x, dz, dpf0 = _block_train_case(blk, c, shift, gen)
            for use_dpf in (False, True):
                row = _block_train_variant(
                    f"block train W96 C={c} shift={shift} clamp  "
                    f"dpf={use_dpf!s:5s}", ops, x, dz,
                    dpf0 if use_dpf else None, "clamp")
                w96.append(dict(c=c, shift=shift, softmax="clamp",
                                dpf=use_dpf, **row))
            if shift == 0:
                times = _block_train_forward_times(x, ops, "clamp")[0]
                w96[-2].update(times)
                log(f"  W96 C={c}: forward {times['ms']:.4f} ms (plain "
                    f"{times['plain_ms']:.4f}, bound {times['bound_ms']:.4f}"
                    f" {times['bound_by']})")
    del w96_model
    log("library yardstick: no single PyTorch call computes a Swin block or "
        "its gradient")
    return {"variants": rows, "tile_rows": tiles, "ptxas": ptxas,
            "w96": w96}


def _swinir_train_argv(data_dir: str, out_dir: str, steps: int) -> list:
    return ["--config-file", SWINIR_TRAIN_CONFIG,
            f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
            f"epochs_in_total={{'WarmUP': {steps}}}",
            f"check_every={TRAIN_CHECK}", "quick_eva_num_samples=8",
            "verbose=False"]


@phase("SwinIR-std bf16 training")
def swinir_train_phase(data_dir: str, tmp: str) -> dict:
    """``python -m rdst_tpu_torch.train`` (in process) on
    ``config_files/swinir_std_100k_oasis20_x4.ini`` for TRAIN_STEPS steps
    with a quick evaluation every TRAIN_CHECK: every block on the
    single-block train kernel (36 forward and 36 backward wrapper calls a
    step, none of the train pair), a finite loss that falls, the quick
    evaluations on the serving kernel, the snapshot served by
    ``LiveModel``; the first step on the kernel route against the plain
    bf16 route."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels import swin_block

    out = {}
    probe = build_trainer(_swinir_train_argv(
        data_dir, os.path.join(tmp, "swinir_probe"), 1))
    probe.setup()
    routes = dict(probe.model.train_routes)
    out["train_routes"] = routes
    log(f"train routes {routes}, eval routes {probe.model.routes}, int8 "
        f"{sorted(probe.model.quant)}, softmax {probe.model.softmax}")
    if routes != {"pair": 0, "block": 36}:
        raise AssertionError(f"train routes {routes}")
    if probe.model.routes != ["fused_swin_block"] * 6 or \
            probe.model.quant != frozenset({"qkv"}):
        raise AssertionError(f"eval routes {probe.model.routes}")
    batch = probe.ds_train.sample(np.random.default_rng(17))
    out.update(_first_step_vs_plain(probe, batch))
    del probe

    out_dir = os.path.join(tmp, "swinir_outputs")
    counters = (bt.launch_forward, bt.launch_backward, pt.launch_forward,
                pt.launch_backward, swin_block.run_fast_block)
    for cnt in counters:
        cnt.launches = 0  # the main path starts here
    bt.launch_backward.reductions = 0
    t0 = time.perf_counter()
    trainer = train_main(_swinir_train_argv(data_dir, out_dir, TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    fwd, bwd, pfwd, pbwd, evals = (cnt.launches for cnt in counters)
    out.update(forward_launches=fwd, backward_launches=bwd,
               reduction_launches=bt.launch_backward.reductions,
               pair_launches=pfwd + pbwd, eval_launches=evals)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): block-train wrapper calls forward {fwd}, backward "
        f"{bwd} (+{bt.launch_backward.reductions} kernels beside the "
        "attention VJPs), "
        f"train-pair {pfwd + pbwd}, fast-block launches in the quick "
        f"evaluations {evals}")
    if fwd != 36 * TRAIN_STEPS or bwd != 36 * TRAIN_STEPS or pfwd + pbwd:
        raise AssertionError(f"expected {36 * TRAIN_STEPS} block-train "
                             "forward and backward calls and no train pair")
    if evals == 0 or evals % 36:
        raise AssertionError(f"quick evaluations: {evals} fast launches")
    losses = trainer.training_loss_records.get("WarmUP", [])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    out["losses"] = losses
    log(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} (first 3 mean "
        f"{first:.5f}, last 3 mean {last:.5f})")
    if not last < first:
        raise AssertionError("the loss did not fall")
    _serve_snapshot(SWINIR_TRAIN_CONFIG, trainer)
    out["trainer"] = trainer
    return out



W96_TRAIN_CONFIG = "config_files/rdst_w96_100k_oasis20_x4.ini"


@phase("W96 bf16 training step")
def w96_train_phase(data_dir: str, tmp: str) -> dict:
    """``python -m rdst_tpu_torch.train`` (in process) on
    ``config_files/rdst_w96_100k_oasis20_x4.ini`` in bf16 for TRAIN_STEPS
    steps with a quick evaluation every TRAIN_CHECK: the C = 96 DSTLs on
    the train pair (8 forward and 8 backward calls a step), the C = 144 /
    192 ones block by block (32 + 32 block-train calls), a finite loss that
    falls, the snapshot served by ``LiveModel``; the first step on the
    kernel route against the plain bf16 route."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt

    def argv(out_dir, steps):
        return _train_argv(data_dir, out_dir, steps, W96_TRAIN_CONFIG) + [
            "training_dtype='bfloat16'"]

    out = {}
    probe = build_trainer(argv(os.path.join(tmp, "w96_probe"), 1))
    probe.setup()
    routes = dict(probe.model.train_routes)
    out["train_routes"] = routes
    log(f"train routes {routes}, eval routes {probe.model.routes}, int8 "
        f"{sorted(probe.model.quant)}, softmax {probe.model.softmax}")
    if probe.model.train_mode != "pair" or routes != {"pair": 8,
                                                      "block": 32}:
        raise AssertionError(f"train routes {probe.model.train_mode} "
                             f"{routes}")
    batch = probe.ds_train.sample(np.random.default_rng(17))
    out.update(_first_step_vs_plain(probe, batch))
    del probe

    counters = (pt.launch_forward, pt.launch_backward, bt.launch_forward,
                bt.launch_backward)
    for cnt in counters:
        cnt.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    trainer = train_main(argv(os.path.join(tmp, "w96_outputs"), TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    pfwd, pbwd, bfwd, bbwd = (cnt.launches for cnt in counters)
    out.update(forward_launches=pfwd, backward_launches=pbwd,
               block_forward_launches=bfwd, block_backward_launches=bbwd)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): train-pair calls forward {pfwd}, backward {pbwd}; "
        f"block-train forward {bfwd}, backward {bbwd}")
    if (pfwd, pbwd, bfwd, bbwd) != (8 * TRAIN_STEPS, 8 * TRAIN_STEPS,
                                    32 * TRAIN_STEPS, 32 * TRAIN_STEPS):
        raise AssertionError("expected 8 train-pair and 32 block-train "
                             "calls each way a step")
    losses = trainer.training_loss_records.get("WarmUP", [])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    out["losses"] = losses
    log(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} (first 3 mean "
        f"{first:.5f}, last 3 mean {last:.5f})")
    if not last < first:
        raise AssertionError("the loss did not fall")
    _serve_snapshot(W96_TRAIN_CONFIG, trainer, inference_dtype="bfloat16")
    del trainer
    return out


# ---------------------------------------------------------------- RDST-W96

# The pair's and the RDSTB's kernels as the profiler names them: the
# token-parallel stages (csrc/token_fwd.cuh), the window body's stage
# kernels and the RDSTB's conv
STAGE_PHASES = (
    ("ln1_rows_kernel", "LN1 rows (int8 or bf16), pre-norm adapter rows"),
    ("EpiQkvS8", "qkv GEMM (int8, wgmma .s8)"),
    ("EpiQkv", "qkv GEMM (bf16, wgmma)"),
    ("attn_fwd_kernel", "attention"),
    ("EpiProjLn", "proj GEMM + residual + LN2 (wgmma)"),
    ("mlp_kernel", "fc1 + tanh GELU + fc2 + residual (wgmma, fused)"),
    ("EpiAdapter", "adapter GEMM + LN into the dense rows (wgmma)"),
    ("stage_kernel<", "window-body stage kernels"),
    ("rdstb_conv_kernel", "conv"),
)


def _gemm_floors(tokens: int, widths, growth: int, int8: bool) -> dict:
    """Byte floors (ms at HBM bandwidth) of the token-parallel GEMM phases
    of a call, by STAGE_PHASES label: two blocks a width, each phase's
    token-major inputs read once and outputs written once, and its
    weights (the f32 x1 4 bytes a value, the rest bf16, int8 rows 1);
    the adapter once a width when ``growth``."""
    t = tokens
    q = p = m = a = 0
    for c in widths:
        q += 2 * (t * c * (1 if int8 else 2) + 3 * c * c + 2 * t * 3 * c)
        p += 2 * (4 * t * c + 2 * c * c + 4 * t * c + 2 * t * (c + 16))
        m += 2 * (8 * t * c + 8 * c * c)
        if growth:
            a += 2 * t * c + 2 * growth * c + 2 * t * growth
    ms = 1e3 / HBM_BYTES_PER_S
    out = {STAGE_PHASES[1 if int8 else 2][1]: q * ms,
           STAGE_PHASES[4][1]: p * ms, STAGE_PHASES[5][1]: m * ms}
    if growth:
        out[STAGE_PHASES[6][1]] = a * ms
    return out


def _log_floors(label: str, stages_ms: dict, floors: dict) -> None:
    for ph, floor in floors.items():
        ms = stages_ms.get(ph)
        log(f"  {label} {ph}: " + (f"{ms:.4f} ms" if ms else "not measured")
            + f" against its byte floor {floor:.4f} ms"
            + (f" ({floor / ms:.2f} of HBM bandwidth)" if ms else ""))


def _stage_bound(tokens: int, widths, int8: bool, extra_flops: float,
                 nbytes: float, n: int = 64):
    """Bound of a pair or RDSTB launch: two blocks a width (16C^2 + 4NC
    flops a token), with int8 qkv their qkv products (6C^2) at the int8
    peak, the rest and ``extra_flops`` (adapters, conv) at the bf16
    peak."""
    q = sum(2 * 6 * c * c for c in widths) * tokens
    rest = sum(2 * (10 * c * c + 4 * n * c) for c in widths) * tokens
    if not int8:
        rest, q = rest + q, 0
    t_ops = ((rest + extra_flops) / BF16_FLOPS + q / INT8_OPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


# The token-parallel forward's GEMMs (csrc/token_wgmma.cuh) alone: the
# widths of RDST-W96's DSTLs and SwinIR-std's blocks; 15 windows (a
# partial last 128-row tile), bucket 1 and bucket 64 of 40x32 slices
GEMM_WIDTHS = (96, 144, 180, 192)
GEMM_TOKENS = (15 * 64, 1280, 81920)
GEMM_GROWTH = 48
INT8_OPS = 1979e12  # dense int8 tensor-core peak (TOP/s)


def _ptxas_kernels(source: str) -> dict:
    """The ptxas report of one library by kernel (mangled name): registers,
    spill bytes (stores + loads), and every wgmma serialization warning
    (C7515 / C7520) naming it."""
    from rdst_tpu_torch.kernels import _build

    out, cur = {}, None
    lines = _build.build_log(source).splitlines()
    for line in lines:
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            out[cur] = {"registers": None, "spill_bytes": 0, "warnings": []}
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(line.split("Used")[1].split()[0])
        elif cur and "spill stores" in line:
            parts = line.replace(",", "").split()
            # "N bytes stack frame, S bytes spill stores, L bytes spill
            # loads"
            out[cur]["spill_bytes"] = (
                int(parts[parts.index("stores") - 3])
                + int(parts[parts.index("loads") - 3]))
    # ptxas prints its warnings before the kernels' reports: a second pass
    for line in lines:
        if "wgmma" in line and ("C7515" in line or "C7520" in line
                                or "serialized" in line):
            for name, rec in out.items():
                if f"'{name}'" in line:
                    rec["warnings"].append(line.strip())
    return out


def _gemm_operands(gen, t: int, c: int, nh: int, hidden: int, growth: int):
    """Seeded operands of one forward's GEMMs at (tokens, C) in the
    forward's buffer layouts (token_dims widths, zeros in the pads, ones
    at column C of the normalized rows) and K-major weights."""
    from rdst_tpu_torch.kernels.swin_block import token_dims

    kp, hp, _, n3, kq = token_dims(c, nh, hidden)
    c8 = -(-c // 8) * 8
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def rows(width, ones):
        r = torch.zeros(t, width, dtype=bf, device="cuda")
        r[:, :c] = rn(t, c).to(bf)
        if ones:
            r[:, c] = 1.0
        return r

    def mat(n, k, nv, kv, dtype=bf):
        m = torch.zeros(n, k, dtype=dtype, device="cuda")
        m[:nv, :kv] = rn(nv, kv, scale=kv ** -0.5).to(dtype)
        return m

    def i8(n, k):
        m = torch.zeros(n, k, dtype=torch.int8, device="cuda")
        m[:, :c] = torch.randint(-127, 128, (n, c), device="cuda",
                                 generator=gen, dtype=torch.int8)
        return m

    return {
        "xq": i8(t, kq), "wq": i8(n3, kq), "ws": rn(n3).abs() * 1e-4,
        "bqkv": rn(n3, scale=0.1), "xn": rows(kp, True),
        "wqkv": mat(n3, kp, n3, c), "ao": rows(kp, True),
        "wproj": mat(kp, kp, c, c), "x": rn(t, c).to(bf),
        "bproj": rn(c, scale=0.1).to(bf), "x1n": rows(kp, True),
        "w1": mat(hp, kp, hidden, c), "w2": mat(kp, hp, c, hidden),
        "bf1": rn(hidden, scale=0.1), "x1": rn(t, c),
        "bf2": rn(c, scale=0.1).to(bf), "z": rows(c8, False),
        "wad": mat(growth, c8, growth, c), "bad": rn(growth, scale=0.1),
        "gad": 1.0 + rn(growth, scale=0.1), "bbad": rn(growth, scale=0.1),
    }


def _gemm_calls(o, c: int, hidden: int):
    """Each GEMM phase as (name, kernel call, plain call, bytes it must
    move, flops, int8, library yardstick of its products alone)."""
    from rdst_tpu_torch.kernels import token_wgmma as tw

    t, n3, growth = o["x"].shape[0], o["wq"].shape[0], o["wad"].shape[0]
    w = {k: v[:, :c] for k, v in o.items() if k in ("wqkv", "wad")}
    lib_w = {"qkv": w["wqkv"].t().contiguous(),
             "proj": o["wproj"][:c, :c].t().contiguous(),
             "fc1": o["w1"][:hidden, :c].t().contiguous(),
             "fc2": o["w2"][:c, :hidden].t().contiguous(),
             "adapter": w["wad"].t().contiguous()}
    a_c = {k: o[k][:, :c].contiguous() for k in ("xn", "ao", "x1n", "z")}
    h = torch.empty(t, hidden, dtype=torch.bfloat16, device="cuda")

    def int_mm():
        return torch._int_mm(o["xq"], o["wq"].t())

    def mlp_mm():
        torch.matmul(a_c["x1n"], lib_w["fc1"], out=h)
        return torch.matmul(h, lib_w["fc2"])

    return [
        ("qkv int8", lambda: tw.qkv_gemm(o["xq"], o["wq"], o["bqkv"],
                                         o["ws"], c=c),
         lambda: tw.qkv_gemm_reference(o["xq"], o["wq"], o["bqkv"], o["ws"],
                                       c=c),
         t * c + n3 * c + 2 * t * n3, 2 * t * c * n3, True, int_mm),
        ("qkv bf16", lambda: tw.qkv_gemm(o["xn"], o["wqkv"], o["bqkv"], c=c),
         lambda: tw.qkv_gemm_reference(o["xn"], o["wqkv"], o["bqkv"], c=c),
         2 * t * c + 2 * n3 * c + 2 * t * n3, 2 * t * c * n3, False,
         lambda: torch.matmul(a_c["xn"], lib_w["qkv"])),
        ("proj + LN2", lambda: tw.proj_ln(o["ao"], o["wproj"], o["x"],
                                          o["bproj"], c=c),
         lambda: tw.proj_ln_reference(o["ao"], o["wproj"], o["x"],
                                      o["bproj"], c=c),
         2 * t * c * 2 + 2 * c * c + 4 * t * c + 2 * t * o["ao"].shape[1],
         2 * t * c * c, False,
         lambda: torch.matmul(a_c["ao"], lib_w["proj"])),
        ("fc1 + fc2", lambda: tw.mlp(o["x1n"], o["w1"], o["w2"], o["bf1"],
                                     o["x1"], o["bf2"], c=c, hidden=hidden),
         lambda: tw.mlp_reference(o["x1n"], o["w1"], o["w2"], o["bf1"],
                                  o["x1"], o["bf2"], c=c, hidden=hidden),
         2 * t * c + 4 * t * c + 2 * t * c + 4 * c * hidden,
         4 * t * c * hidden, False, mlp_mm),
        ("adapter (pre-norm)", lambda: tw.adapter(
            o["z"], o["wad"], o["bad"], o["gad"], o["bbad"], c=c,
            prenorm=True),
         lambda: tw.adapter_reference(o["z"], o["wad"], o["bad"], o["gad"],
                                      o["bbad"], c=c, prenorm=True),
         2 * t * c + 2 * growth * c + 2 * t * growth, 2 * t * c * growth,
         False, lambda: torch.matmul(a_c["z"], lib_w["adapter"])),
        ("adapter (post-norm)", lambda: tw.adapter(
            o["z"], o["wad"], o["bad"], o["gad"], o["bbad"], c=c,
            prenorm=False),
         lambda: tw.adapter_reference(o["z"], o["wad"], o["bad"], o["gad"],
                                      o["bbad"], c=c, prenorm=False),
         2 * t * c + 2 * growth * c + 2 * t * growth, 2 * t * c * growth,
         False, lambda: torch.matmul(a_c["z"], lib_w["adapter"])),
    ]


def _gemm_launches(o, c: int, hidden: int, bm: int = 0) -> dict:
    """Each GEMM phase's kernel launch alone, by name (outputs allocated
    once, x1 packed once), for its CUDA-event time: the wrappers of
    ``kernels.token_wgmma`` add x1's layout copies and allocations. bm:
    the qkv, proj and MLP kernels' tile rows (64, 128; 0: the
    schedule's)."""
    from rdst_tpu_torch.kernels import _build
    from rdst_tpu_torch.kernels import token_wgmma as tw
    from rdst_tpu_torch.kernels.swin_block import launch

    lib = _build.load("swin_block_fast.cu")
    dev = o["x"].device
    t, kp = o["ao"].shape
    hp, n3, kq = o["w1"].shape[0], o["wq"].shape[0], o["wq"].shape[1]
    growth, ldz = o["wad"].shape
    bf = torch.bfloat16
    q = torch.empty(t, n3, dtype=bf, device=dev)
    x1 = tw.x1_pack(o["x1"])
    x1_out = torch.empty_like(x1)
    x1n = torch.empty(t, kp, dtype=bf, device=dev)
    out = torch.empty(t, c, dtype=bf, device=dev)
    ad = torch.empty(t, growth, dtype=bf, device=dev)

    def run(entry, ptrs, dims):
        return lambda: launch(lib, entry, ptrs, dims, dev)

    adapter = [o["z"], o["wad"], o["bad"], o["gad"], o["bbad"], ad]
    return {
        "qkv int8": run("tokwg_qkv", [o["xq"], o["wq"], o["ws"], o["bqkv"],
                                      q], [t, c, n3, kq, bm]),
        "qkv bf16": run("tokwg_qkv", [o["xn"], o["wqkv"], 0, o["bqkv"], q],
                        [t, c, n3, kp, bm]),
        "proj + LN2": run("tokwg_proj_ln", [o["ao"], o["wproj"], o["x"],
                                            o["bproj"], x1_out, x1n],
                          [t, c, kp, bm]),
        "fc1 + fc2": run("tokwg_mlp", [o["x1n"], o["w1"], o["w2"], o["bf1"],
                                       x1, o["bf2"], out],
                         [t, c, hidden, kp, hp, bm]),
        "adapter (pre-norm)": run("tokwg_adapter", adapter,
                                  [t, c, ldz, growth, 1]),
        "adapter (post-norm)": run("tokwg_adapter", adapter,
                                   [t, c, ldz, growth, 0]),
    }


@phase("token GEMMs vs plain")
def token_gemm_phase() -> dict:
    """The token-parallel forward's GEMMs (csrc/token_wgmma.cuh) one at a
    time on seeded operands, at C = 96 / 144 / 180 / 192 and 960 / 1280
    / 81920 tokens: the int8 qkv product bitwise against its plain
    version (exact integer sums, then the epilogue's roundings), the
    bf16 ones within BF16_TOL; at 81920 tokens each one's launch alone
    (CUDA events over 30) beside its byte floor and bound, and a library
    product of the same shapes as a yardstick of the products alone
    (``torch.matmul``, ``torch._int_mm``), without the fused epilogue.
    Then the ptxas report of the kernels: registers, spills (none
    allowed) and wgmma serialization warnings (none allowed)."""
    out = {"cases": [], "timed": [], "ptxas": {}}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    nh = 6
    for c in GEMM_WIDTHS:
        hidden = 2 * c
        for t in GEMM_TOKENS:
            o = _gemm_operands(gen, t, c, nh, hidden, GEMM_GROWTH)
            raw = _gemm_launches(o, c, hidden)
            for name, call, plain, nbytes, flops, int8, lib in _gemm_calls(
                    o, c, hidden):
                with torch.inference_mode():
                    got, want = call(), plain()
                    torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if int8:
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    if not same:
                        bad = int((got[0] != want[0]).sum())
                        raise AssertionError(
                            f"{name} C={c} T={t}: {bad} q/k/v values differ "
                            "from the exact plain sums")
                    err = (0.0, 0.0, 0.0)
                else:
                    errs = [_check(f"{name} C={c} T={t}", a, b)
                            for a, b in zip(got, want)]
                    err = tuple(max(e[i] for e in errs) for i in range(3))
                case = dict(name=name, c=c, tokens=t, rel_max=err[0],
                            rel_mean=err[1], max_abs_err=err[2],
                            bitwise=int8)
                out["cases"].append(case)
                if t != GEMM_TOKENS[-1]:
                    continue
                with torch.inference_mode():
                    ms = cuda_time_ms(raw[name], warmup=3, iters=30)
                    try:
                        lib_ms = cuda_time_ms(lib)
                    except RuntimeError as exc:
                        log(f"  {name} C={c}: library yardstick refused "
                            f"({exc})")
                        lib_ms = None
                floor = nbytes / HBM_BYTES_PER_S * 1e3
                ops = flops / (INT8_OPS if int8 else BF16_FLOPS) * 1e3
                row = dict(case, ms=ms, byte_floor_ms=floor,
                           bound_ms=max(floor, ops),
                           bound_by="bytes" if floor >= ops else "operations",
                           library_ms=lib_ms,
                           hbm_share=floor / ms if ms else None)
                out["timed"].append(row)
                log(f"  {name} C={c} T={t}: "
                    + (f"{ms:.4f} ms" if ms else "not measured")
                    + f", byte floor {floor:.4f} ms (ops {ops:.4f})"
                    + (f", {floor / ms:.2f} of HBM" if ms else "")
                    + "; library yardstick (products alone) "
                    + (f"{lib_ms:.4f} ms" if lib_ms else "none")
                    + ("; bitwise" if int8 else f"; rel max {err[0]:.2e}"))
            del o, raw
        log(f"token GEMMs C={c}: every case at T = {GEMM_TOKENS} agrees "
            "(int8 bitwise, bf16 within BF16_TOL)")
    for src in ("swin_block_fast.cu", "swin_pair.cu", "rdstb_block.cu"):
        kernels = {k: v for k, v in _ptxas_kernels(src).items()
                   if "tokwg" in k}
        out["ptxas"][src] = kernels
        for name, rec in kernels.items():
            log(f"  ptxas {src} {name}: {rec['registers']} registers, "
                f"{rec['spill_bytes']} spill bytes, "
                f"{len(rec['warnings'])} wgmma warnings")
            if rec["spill_bytes"] or rec["warnings"]:
                raise AssertionError(f"{src} {name}: {rec}")
        if not kernels:
            raise AssertionError(f"{src}: no token GEMM kernel in the "
                                 "ptxas report")
    return out


@phase("W96 kernels vs plain")
def w96_kernel_phase(model32, model16) -> dict:
    """RDST-W96's kernels at bucket 64 (64 images of 40x32) with its
    committed weights (the first RDSTB): the f32 block at C = 96 / 144 /
    192 (``_f32_variant``); the RDSTB with int8 qkv (its pre-norm
    adapters, shift 4, the checkpoint's resolved softmax) and the pair at
    C = 96 / 144 / 192 with int8 qkv, each against its plain and staged
    versions (bar BF16_TOL), two calls bitwise equal, kernels a call,
    CUDA-event ms of the launch alone beside its bound (the qkv products
    at the int8 peak) and the plain version's, device time per stage
    kernel; the pair at C = 96 with bf16 qkv in both stage designs (the
    window body, the token-parallel stages) side by side."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_pair

    ws, nw, images, nh = 8, 20, 64, 6
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    quant = frozenset({"qkv"})
    softmax = model16.softmax
    f32_kernels = _f32_kernels()
    out = {"f32": [_f32_variant(blk, shift, gen, f32_kernels)
                   for blk, shift in _rdst_blocks(model32)],
           "pair": [], "rdstb": []}
    rdstb = model16.body[0]
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax=softmax)
    for c, dstl in zip((96, 144, 192), rdstb.body):
        a, b = dstl.body.blocks
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        designs = [("tokens", quant)] + ([("window", frozenset()),
                                          ("tokens", frozenset())]
                                         if c == 96 else [])
        for design, q in designs:
            route = {"window": "stage", "tokens": "tokens"}[design]
            plan_a = _pair_plan(a, LR_HW, ws, 0, q, route)
            plan_b = _pair_plan(b, LR_HW, ws, ws // 2, q, route)
            args = (x, plan_a.params, plan_a.bias, plan_b.params,
                    plan_b.bias)
            qkw = dict(qkv_a=plan_a.qkv, qkv_b=plan_b.qkv, **kw)
            label = f"pair C={c} {'int8' if q else 'bf16'} qkv ({design})"

            def call():
                return swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)

            with torch.inference_mode():
                got = call()
                want = swin_pair.swin_pair_reference(*args, **qkw)
                staged = swin_pair.swin_pair_staged_reference(*args, **qkw)
                torch.cuda.synchronize()
                err = _check(label, got, want)
                err_s = _check(f"{label} vs staged", got, staged)
                ms = cuda_time_ms(call)
                plain_ms = cuda_time_ms(
                    lambda: swin_pair.swin_pair_reference(*args, **qkw),
                    warmup=1, iters=5)
                extras = _stage_extras(label, call, swin_pair.run_swin_pair,
                                       STAGE_PHASES)
            bound_ms, by = _stage_bound(
                images * nw * ws * ws, (c,), bool(q), 0.0,
                2 * 2 * x.numel() + _plan_bytes(plan_a) + _plan_bytes(plan_b)
                + _nbytes(*plan_a.qkv_layout, *plan_b.qkv_layout))
            floors = (_gemm_floors(images * nw * ws * ws, (c,), 0, bool(q))
                      if design == "tokens" else {})
            _log_floors(label, extras["stages_ms"], floors)
            row = dict(c=c, int8=bool(q), design=design, rel_max=err[0],
                       rel_mean=err[1], max_abs_err=err[2],
                       staged_rel_max=err_s[0], ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=by, gemm_floor_ms=floors,
                       **extras)
            out["pair"].append(row)
            log(f"{label} {softmax}: rel max {err[0]:.3e} mean {err[1]:.3e},"
                f" vs staged {err_s[0]:.3e}; kernels {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by})")
    h, w = LR_HW
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(LR_HW, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm,
        quant=quant)
    if plan.routes != ["tokens"] * 3:
        raise AssertionError(f"W96 RDSTB with int8 qkv: routes {plan.routes}")
    x = torch.randn(images, h * w, 96, device="cuda",
                    generator=gen).to(torch.bfloat16)
    rkw = dict(growth=plan.growth, adapter_prenorm=plan.prenorm, **kw)

    def call():
        return rdstb_block.run_rdstb(x, plan, **kw)

    with torch.inference_mode():
        got = call()
        want = rdstb_block.rdstb_reference(x, plan.dstls, plan.wc, plan.bc,
                                           **rkw)
        staged = rdstb_block.rdstb_staged_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw)
        torch.cuda.synchronize()
        err = _check("W96 rdstb int8 qkv", got, want)
        err_s = _check("W96 rdstb int8 qkv vs staged", got, staged)
        ms = cuda_time_ms(call)
        plain_ms = cuda_time_ms(lambda: rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw), warmup=1, iters=3)
        extras = _stage_extras("W96 rdstb int8 qkv", call,
                               rdstb_block.run_rdstb, STAGE_PHASES)
    ccat = 96 + 3 * 48
    adapter_conv = (sum(2 * c * 48 for c in (96, 144, 192)) * images * h * w
                    + images * h * w * 2 * 9 * ccat * 96)
    nbytes = 2 * 2 * x.numel() + sum(
        _nbytes(*d.pa, *d.pb, d.bias_a, d.bias_b, *d.adapter, *d.qa, *d.qb)
        for d in plan.dstls) + _nbytes(plan.wc, plan.bc)
    bound_ms, by = _stage_bound(images * h * w, (96, 144, 192), True,
                                adapter_conv, nbytes)
    floors = _gemm_floors(images * h * w, (96, 144, 192), 48, True)
    _log_floors("W96 rdstb int8 qkv", extras["stages_ms"], floors)
    out["rdstb"].append(dict(rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], staged_rel_max=err_s[0],
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by, gemm_floor_ms=floors, **extras))
    log(f"W96 rdstb int8 qkv {softmax}: rel max {err[0]:.3e} mean "
        f"{err[1]:.3e}, vs staged {err_s[0]:.3e}; kernels {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by})")
    log("library yardstick: no single PyTorch call computes a DSTL pair or "
        "an RDSTB")
    return out


def _pair_plan(block, x_size, ws: int, shift: int, quant, route: str):
    """A model block's fast-branch plan for a pair stage design."""
    from rdst_tpu_torch.kernels.swin_block import plan_fast_block

    return plan_fast_block(*block.fast_kernel_inputs(x_size, ws, shift),
                           num_heads=block.num_heads, quant=quant,
                           route=route)


@phase("W96 whole model")
def w96_model_phase(live32, live16) -> dict:
    """RDST-W96 with its committed 40k weights on 8 seeded 40x32 slices:
    f32 as shipped on the f32 block kernel (48 launches a forward) against
    the plain f32 path (bar MODEL_TOL); bf16 with int8 qkv in modes rdstb
    (the default), pair and swin (8 / 24 / 48 launches a forward, counts
    set to 0 just before each and read just after), each against the f32
    model (< BF16_VS_F32_MAX max, < BF16_VS_F32_MEAN mean, relative) and
    modes rdstb and pair against mode swin, whose kernel was ported
    before; per mode the wall and device time of one warm bucket-64
    forward."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair
    from rdst_tpu_torch.models.rdst import set_kernel_mode
    from rdst_tpu_torch.nn.swin import set_block_kernels

    rng = np.random.default_rng(SEED + 13)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    x64 = rng.random((64,) + LR_HW, dtype=np.float32)
    swin_block.fused_swin_block.launches = 0  # the f32 path starts here
    y32 = live32.predict(x, SCALE)
    launches = swin_block.fused_swin_block.launches  # and ends here
    set_block_kernels(live32.model, False)
    try:
        y32_plain = live32.predict(x, SCALE)
    finally:
        set_block_kernels(live32.model, True)
    err = float(np.abs(y32 - y32_plain).max())
    log(f"W96 f32: {launches} fused_swin_block launches per forward; kernel "
        f"path vs plain path max abs err {err:.3e} (tol {MODEL_TOL})")
    if launches != 48 or err > MODEL_TOL or not np.isfinite(y32).all():
        raise AssertionError(f"W96 f32: {launches} launches, err {err}")
    wall, busy = _device_ms(lambda: live32.predict(x64, SCALE))
    out = {"f32": {"launches_per_forward": launches, "max_abs_err": err,
                   "bucket64_wall_ms": wall, "bucket64_device_ms": busy}}
    log(f"W96 f32: one warm bucket-64 forward {wall:.3f} ms wall, device "
        + (f"{busy:.3f} ms" if busy is not None else "not measured"))

    def versus(y, ref):
        r = _rel(torch.from_numpy(y), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((y - ref) ** 2)))

    model, softmax, quant = live16.model, live16.model.softmax, \
        live16.model.quant
    counters = {"swin": (swin_block.run_fast_block, 48),
                "rdstb": (rdstb_block.run_rdstb, 8),
                "pair": (swin_pair.run_swin_pair, 24)}
    ys = {}
    try:
        for mode, (counter, want_launches) in counters.items():
            set_kernel_mode(model, mode, softmax, quant)
            for c, _ in counters.values():
                c.launches = 0  # this mode's path starts here
            y = live16.predict(x, SCALE)
            launches = {c.__name__: c.launches for c, _ in counters.values()}
            if launches[counter.__name__] != want_launches or sum(
                    launches.values()) != want_launches:
                raise AssertionError(f"W96 mode {mode}: launches {launches}")
            if not np.isfinite(y).all():
                raise AssertionError(f"W96 mode {mode}: non-finite output")
            ys[mode] = y
            kf = versus(y, y32)
            ks = versus(y, ys["swin"]) if mode != "swin" else (None, None)
            log(f"W96 bf16 int8 qkv mode {mode}: {want_launches} launches of "
                f"{counter.__name__} per forward; vs the f32 model rel max "
                f"{kf[0]:.3e} mean {kf[1]:.3e}, PSNR {kf[2]:.2f} dB" + (
                    f"; vs mode swin rel max {ks[0]:.3e} mean {ks[1]:.3e}"
                    if ks[0] is not None else ""))
            if kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
                raise AssertionError(f"W96 mode {mode} vs f32: {kf}")
            wall, busy = _device_ms(lambda: live16.predict(x64, SCALE))
            log(f"W96 bf16 mode {mode}: one warm bucket-64 forward "
                f"{wall:.3f} ms wall, device " + (
                    f"{busy:.3f} ms" if busy is not None else "not measured"))
            out[mode] = {"launches_per_forward": want_launches,
                         "vs_f32_rel_max": kf[0], "vs_f32_rel_mean": kf[1],
                         "psnr_vs_f32_db": kf[2], "vs_swin_rel_max": ks[0],
                         "vs_swin_rel_mean": ks[1],
                         "bucket64_wall_ms": wall, "bucket64_device_ms": busy}
    finally:
        set_kernel_mode(model, "rdstb", softmax, quant)
    return out


w96_serving_phase = phase("W96 f32 serving")(_serve)
w96_bf16_serving_phase = phase("W96 bf16 serving")(_serve)
w96_profile_phase = phase("W96 f32 profile")(_profile)
w96_bf16_profile_phase = phase("W96 bf16 profile")(_profile)


@phase("W96 train-pair kernels vs plain")
def w96_train_kernel_phase(model) -> dict:
    """Phase 11 at RDST-W96's pair width, C = 96, with its committed
    weights (the first RDSTB's first DSTL)."""
    rows = _train_pair_widths(model, ((0, 96),), "W96")
    return {"variants": rows}


# ---------------------------------------------------------------------------
# The tester path (python -m rdst_tpu_torch.test): the README quality rows
# on the held-out patients of the 20-phantom corpus
# ---------------------------------------------------------------------------

# a row's PSNR (dB) and SSIM against its bar; a bf16 row against its f32
# row by the same amounts
TESTER_PSNR_TOL, TESTER_SSIM_TOL = 0.02, 0.002
# tiled inference against whole-slice SR (tests/test_e2e.py:229)
TILED_TOL_DB = 2.0
TILED_STRIDE = 12
HRL_CONFIG = "config_files/rdst_hrl_seg_ft_oasis20_x4.ini"
HRL_WEIGHTS = "weights/rdst_hrl_ft_best_oasis20_x4.msgpack"
GAN_CONFIG = "config_files/rdst_gan_ft_oasis20_x4.ini"
GAN_WEIGHTS = "weights/rdst_ganft_5k_best_oasis20_x4.msgpack"
GAN2_CONFIG = "config_files/rdst_gan_ft2_oasis20_x4.ini"
GAN2_WEIGHTS = "weights/rdst_ganft2_10k_best_oasis20_x4.msgpack"
LIGHT_CONFIG = "config_files/swinir_light_40k_oasis20_x4.ini"
LIGHT_WEIGHTS = "weights/swinir_light_40k_best_oasis20_x4.msgpack"
# The bars: the JAX tester's own numbers for each row on this corpus
# (``tools/jax_tester_bars.py``: ``rdst_tpu.runners.tester`` on the CPU,
# patients 19-20 of the same seeded corpus, the bf16 rows with the Pallas
# kernels in interpret mode, int8 qkv included, as on a TPU), each beside its
# README:83-90 figure (the GAN rows' vifp and lpips from the JAX package's
# record, git show d4572e2:PERF.md). SwinIR-std's README 28.49 / 0.886
# is 0.015 dB off the JAX tester's own number; the JAX tester is the bar.
TESTER_BARS = {
    "bicubic": {"readme": (23.93, 0.708), "psnr": 23.9326, "ssim": 0.7082},
    "E1 f32": {"readme": (27.39, 0.856), "psnr": 27.3906, "ssim": 0.8564},
    "E1 bf16": {"readme": None, "psnr": 27.3918, "ssim": 0.8565},
    "E1 f32 tiled": {"readme": None, "psnr": 29.7100, "ssim": 0.8994},
    "E1 f32 tiled 12/6": {"readme": None, "psnr": 26.7503, "ssim": 0.8176},
    "HRL fine-tune": {"readme": (27.46, 0.857), "psnr": 27.4596,
                      "ssim": 0.8573},
    "RaGAN fine-tune 5k": {"readme": (27.53, 0.8556, 0.8023, 0.00282),
                           "psnr": 27.5282, "ssim": 0.8556, "vifp": 0.8023,
                           "lpips": 0.002824},
    "RaGAN fine-tune 2 10k": {"readme": (27.41, 0.8564, 0.8063, 0.00285),
                              "psnr": 27.4143, "ssim": 0.8564,
                              "vifp": 0.8063, "lpips": 0.002851},
    "SwinIR-light": {"readme": (27.02, 0.848), "psnr": 27.0154,
                     "ssim": 0.8475},
    "SwinIR-std": {"readme": (28.49, 0.886), "psnr": 28.4746, "ssim": 0.8853},
    "W96 f32": {"readme": (28.21, 0.872), "psnr": 28.2068, "ssim": 0.8718},
    "W96 bf16": {"readme": None, "psnr": 28.1681, "ssim": 0.8710},
}
# vifp and lpips against their bars (host metrics on the card's outputs)
TESTER_VIFP_TOL, TESTER_LPIPS_TOL = 0.002, 1e-4


def _tester_patients(data_dir: str) -> dict:
    """{patient id: its test pairs}, as the tester builds them (every
    oasis20 config has the same data keys)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.data.readers import (make_test_dataset,
                                             testing_patient_ids)

    p = ParametersLoader(CONFIG)
    p.set("data_folder", data_dir)
    out = {}
    for pid in testing_patient_ids(p):
        ds = make_test_dataset(p, [pid])
        out[pid] = [ds.get_test_pair(i) for i in range(ds.test_len())]
    return out


def _images(patients: dict) -> list:
    """Slices per patient: the batch of one whole-patient forward."""
    return [len(pairs) for pairs in patients.values()]


def _tester_geometries(patients: dict) -> list:
    """(slices, image size) of the kernel checks: each whole patient at
    its LR slice padded to whole windows of 8 (what the kernels see in
    the tester's forward), and at the serving geometry 40x32."""
    h, w = _lr_hw(patients)
    padded = (-(-h // 8) * 8, -(-w // 8) * 8)
    return [(n, hw) for hw in (padded, LR_HW) for n in _images(patients)]


def _lr_hw(patients: dict):
    return next(iter(patients.values()))[0][4.0]["in"].shape[1:3]


def _f32_block_at(block, shift: int, images: int, x_size, gen) -> dict:
    """The f32 block kernel against its plain version on ``images``
    images of ``x_size`` (one whole patient)."""
    from rdst_tpu_torch.kernels import swin_block as sb

    ws, nh, c = 8, block.num_heads, block.dim
    nw = (x_size[0] // ws) * (x_size[1] // ws)
    params, bias = block.kernel_inputs(x_size, ws, shift)
    x = torch.randn(images * nw, ws * ws, c, device="cuda", generator=gen)
    kw = dict(num_heads=nh, windows_per_image=nw)
    with torch.inference_mode():
        plan = sb.plan_f32_block(params, bias, num_heads=nh)
        got = sb.run_f32_block(x, plan, **kw)
        want = sb.swin_block_reference(x, *plan.params, bias, **kw)
        err = (got - want).abs().max().item()
        ms = cuda_time_ms(lambda: sb.run_f32_block(x, plan, **kw),
                          warmup=1, iters=5)
    label = (f"f32 block C={c} shift={shift} at {images} x {x_size} "
             f"({images * nw} windows)")
    log(f"{label}: max abs err {err:.3e} (tol {KERNEL_TOL}), {ms:.4f} ms")
    if not (err <= KERNEL_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: {err} > {KERNEL_TOL}")
    return dict(c=c, shift=shift, images=images, x_size=list(x_size),
                windows=images * nw, max_abs_err=err, ms=ms)


def _rdstb_at(rdstb, images: int, x_size, gen, softmax: str,
              quant=frozenset()) -> dict:
    """The RDSTB kernel against its plain version on ``images`` images of
    ``x_size`` with ``rdstb``'s weights."""
    from rdst_tpu_torch.kernels import rdstb_block

    ws, nh = 8, 6
    h, w = x_size
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(x_size, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm,
        quant=quant)
    c0 = rdstb.body[0].body.blocks[0].dim
    x = torch.randn(images, h * w, c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=x_size, window_size=ws, shift=ws // 2,
              softmax=softmax)
    windows = images * (h // ws) * (w // ws)
    label = (f"rdstb C0={c0}{' int8 qkv' if quant else ''} at {images} x "
             f"{tuple(x_size)} ({windows} windows)")
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, growth=plan.growth,
            adapter_prenorm=plan.prenorm, **kw)
        torch.cuda.synchronize()
        err = _check(label, got, want)
        ms = cuda_time_ms(lambda: rdstb_block.run_rdstb(x, plan, **kw),
                          warmup=1, iters=5)
    log(f"{label}: rel max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}), "
        f"{ms:.4f} ms")
    return dict(images=images, x_size=list(x_size), windows=windows,
                rel_max=err[0], rel_mean=err[1], max_abs_err=err[2], ms=ms)


def _fast_block_at(block, images: int, x_size, gen, softmax: str,
                   quant) -> dict:
    """The fast block against its plain version on ``images`` images of
    ``x_size`` (one whole patient), unshifted (SwinIR-std's blocks at its
    build resolution)."""
    from rdst_tpu_torch.kernels import swin_block

    ws, nh, c = 8, block.num_heads, block.dim
    nw = (x_size[0] // ws) * (x_size[1] // ws)
    plan = swin_block.plan_fast_block(*block.fast_kernel_inputs(x_size, ws, 0),
                                      num_heads=nh, quant=quant)
    x = torch.randn(images * nw, ws * ws, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
    label = (f"fast block C={c}{' int8 qkv' if quant else ''} "
             f"({plan.route}) at {images} x {tuple(x_size)} "
             f"({images * nw} windows)")
    with torch.inference_mode():
        got = swin_block.run_fast_block(x, plan, **kw)
        want = swin_block.swin_block_fast_reference(
            x, plan.params, plan.bias, num_heads=nh, softmax=softmax,
            qkv=plan.qkv)
        torch.cuda.synchronize()
        err = _check(label, got, want)
        ms = cuda_time_ms(lambda: swin_block.run_fast_block(x, plan, **kw),
                          warmup=1, iters=5)
    log(f"{label}: rel max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}), "
        f"{ms:.4f} ms")
    return dict(c=c, images=images, x_size=list(x_size), windows=images * nw,
                rel_max=err[0], rel_mean=err[1], max_abs_err=err[2], ms=ms)


def _tiled_chunk(model32, model16, gen, patches: int = 128) -> dict:
    """One chunk of the tester's tiled inference (``max(4 * batch_size,
    8)`` = 128 LR patches of 24x24) through the f32 model, kernel path
    against its plain path (bar MODEL_TOL), and through the bf16 model
    against the f32 kernel path (the bf16-vs-f32 bars)."""
    from rdst_tpu_torch.nn.swin import set_block_kernels

    x = torch.rand(patches, 24, 24, 1, device="cuda", generator=gen)
    with torch.inference_mode():
        y = model32(x)
        set_block_kernels(model32, False)
        try:
            y_plain = model32(x)
        finally:
            set_block_kernels(model32, True)
        y16 = model16(x).float()
    err = (y - y_plain).abs().max().item()
    r16 = _rel(y16, y)
    log(f"tiled chunk of {patches} LR 24x24 patches: f32 kernel vs plain max "
        f"abs err {err:.3e} (tol {MODEL_TOL}); bf16 ({model16.kernel_mode}) "
        f"vs f32 rel max {r16[0]:.3e} mean {r16[1]:.3e} (bars "
        f"{BF16_VS_F32_MAX}, {BF16_VS_F32_MEAN})")
    if y.shape != (patches, 96, 96, 1) or not torch.isfinite(y16).all():
        raise AssertionError(f"tiled chunk: {y.shape}")
    if err > MODEL_TOL:
        raise AssertionError(f"tiled chunk f32 kernel vs plain: {err}")
    if r16[0] >= BF16_VS_F32_MAX or r16[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"tiled chunk bf16 vs f32: {r16}")
    return {"f32_max_abs_err": err, "bf16_vs_f32_rel_max": r16[0],
            "bf16_vs_f32_rel_mean": r16[1]}


def _tester_forwards(tester, patients: dict) -> int:
    """Model forwards of one tester run: one a patient, or its tiled
    chunks."""
    from rdst_tpu_torch.data.folding import ImageFolder

    if not tester.paras.get("tiled_inference", False):
        return len(patients)
    patch = int(tester.paras.patch_size)
    stride = int(tester.paras.get("test_lr_patch_stride", patch))
    chunk = max(tester.paras.batch_size * 4, 8)
    total = 0
    for n in _images(patients):
        folder = ImageFolder((n,) + tuple(_lr_hw(patients)) + (1,), patch,
                             stride)
        total += -(-n * folder.num_patches // chunk)
    return total


def _tester_row(label: str, config: str, weights, data_dir: str, tmp: str,
                patients: dict, counter=None, per_forward: int = 0,
                bar=None, **overrides) -> dict:
    """``cli.test_main`` on the card for one row (its own output tree):
    the mean scores over every held-out slice against ``bar`` ({metric:
    value}; PSNR and SSIM must hold TESTER_PSNR_TOL / TESTER_SSIM_TOL),
    ``counter``'s launches (set to 0 just before the run, read just after:
    ``per_forward`` a forward), and per patient the tester's inference
    wall time (its report) and one warm forward's wall and device time."""
    from rdst_tpu_torch.cli import test_main

    over = {"data_folder": data_dir, "verbose": False,
            "output_dir": os.path.join(tmp, "tester", label.replace(" ", "_")),
            **overrides}
    if weights:
        over["well_trained_single_scale_model_g"] = weights
    argv = ["--config-file", config] + [f"{k}={v!r}" for k, v in over.items()]
    if counter is not None:
        counter.launches = 0  # the tester's path starts here
    t0 = time.perf_counter()
    tester = test_main(argv)
    wall = time.perf_counter() - t0
    launches = counter.launches if counter is not None else 0  # and ends here
    stacked = np.load(os.path.join(tester.output_root,
                                   "stacked_eva_reports.npy"),
                      allow_pickle=True).item()
    scores = {m: float(np.mean(stacked[f"{m}_4.0"]))
              for m in tester.eva_func.basic_metrics}
    patients_out = []
    for pid in tester.patient_ids:
        rep = np.load(os.path.join(tester.dirs["eva_reports"],
                                   f"{pid}_eva_reports.npy"),
                      allow_pickle=True).item()
        row = {"pid": pid, "slices": rep["num_slices"],
               "inference_s": rep["inference_time_cost"]}
        if tester.model is not None:
            pairs = patients[pid]
            lr = np.concatenate([p[4.0]["in"] for p in pairs])
            if tester.paras.get("tiled_inference", False):
                def sr():
                    return tester._tiled_inference(lr, 4.0, pairs)
            else:
                def sr():
                    return tester.forward(lr).cpu().numpy()
            row["forward_ms"], row["device_ms"] = _device_ms(sr)
            # the host metrics of the patient's slices, alone
            recs = [{4.0: y} for y in sr()]
            t1 = time.perf_counter()
            tester.eva_func(recs, pairs)
            row["metrics_s"] = time.perf_counter() - t1
        patients_out.append(row)
    out = {"label": label, "config": config, "weights": weights,
           "scores": scores, "slices": len(stacked["psnr_4.0"]),
           "wall_s": wall, "patients": patients_out,
           "manifest": tester.manifest}
    if counter is not None:
        forwards = _tester_forwards(tester, patients)
        out["launches"] = launches
        if launches != per_forward * forwards:
            raise AssertionError(f"tester {label}: {launches} launches, "
                                 f"expected {per_forward} x {forwards}")
    text = " ".join(f"{m} {v:.4f}" if m != "lpips" else f"{m} {v:.6f}"
                    for m, v in scores.items())
    per = "; ".join(
        f"{r['pid']} {r['slices']} slices inference {r['inference_s']:.3f} s"
        + (f", forward {r['forward_ms']:.3f} ms wall / "
           f"{r['device_ms'] or float('nan'):.3f} ms device, metrics "
           f"{r['metrics_s']:.3f} s" if "forward_ms" in r else "")
        for r in patients_out)
    shown = None if bar is None else {k: v for k, v in bar.items()
                                      if k != "readme"}
    readme = "" if bar is None or not bar.get("readme") else \
        f", README {bar['readme']}"
    log(f"tester {label}: {text} over {out['slices']} slices (bar "
        f"{shown}{readme}); {per}; run {wall:.3f} s"
        + (f"; {launches} launches of {counter.__name__}"
           if counter is not None else ""))
    if bar is not None:
        tols = {"psnr": TESTER_PSNR_TOL, "ssim": TESTER_SSIM_TOL,
                "vifp": TESTER_VIFP_TOL, "lpips": TESTER_LPIPS_TOL}
        out["delta"] = {m: scores[m] - bar[m] for m in tols if m in bar}
        off = {m: d for m, d in out["delta"].items() if abs(d) > tols[m]}
        if off:
            raise AssertionError(f"tester {label}: {scores} against bar "
                                 f"{bar}: {off} past {tols}")
    return out


def _versus_f32(label: str, row16: dict, row32: dict) -> dict:
    """A bf16 row against its f32 row: logged; past TESTER_PSNR_TOL /
    TESTER_SSIM_TOL it fails."""
    d = {m: row16["scores"][m] - row32["scores"][m] for m in ("psnr", "ssim")}
    log(f"{label} against f32: {d['psnr']:+.4f} dB, SSIM {d['ssim']:+.5f} "
        f"(tol {TESTER_PSNR_TOL}, {TESTER_SSIM_TOL})")
    if abs(d["psnr"]) > TESTER_PSNR_TOL or abs(d["ssim"]) > TESTER_SSIM_TOL:
        raise AssertionError(f"{label} against f32: {d}")
    row16["versus_f32"] = d
    return d


@phase("E1 tester")
def e1_tester_phase(data_dir: str, tmp: str, patients: dict, live32,
                    live16) -> dict:
    """The kernels at the tester's batch sizes against their plain
    versions (the f32 block and the RDSTB at one whole patient's windows,
    a tiled chunk in f32 and bf16), then ``cli.test_main`` on the card
    for the bicubic, E1 f32, E1 bf16, E1 f32 tiled (stride 12), HRL and
    the two RaGAN fine-tune rows."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    kern = {"f32": [], "rdstb": []}
    for images, x_size in _tester_geometries(patients):
        kern["f32"] += [_f32_block_at(blk, shift, images, x_size, gen)
                        for blk, shift in _rdst_blocks(live32.model)[:2]]
        kern["rdstb"].append(_rdstb_at(live16.model.body[0], images, x_size,
                                       gen, live16.model.softmax))
    kern["rdstb"].append(_rdstb_at(live16.model.body[0], 128, (24, 24), gen,
                                   live16.model.softmax))
    kern["tiled"] = _tiled_chunk(live32.model, live16.model, gen)
    f32, run = swin_block.fused_swin_block, rdstb_block.run_rdstb
    rows = {}

    def row(label, config, weights, counter=None, per_forward=0, bar=None,
            **kw):
        rows[label] = _tester_row(label, config, weights, data_dir, tmp,
                                  patients, counter, per_forward, bar, **kw)
        return rows[label]

    row("bicubic", CONFIG, None, bar=TESTER_BARS["bicubic"],
        feature_generator="bicubic")
    e1 = row("E1 f32", CONFIG, WEIGHTS, f32, 48, TESTER_BARS["E1 f32"])
    e1_16 = row("E1 bf16", CONFIG, WEIGHTS, run, 8, TESTER_BARS["E1 bf16"],
                inference_dtype="bfloat16")
    _versus_f32("E1 bf16", e1_16, e1)
    tiled = row("E1 f32 tiled", CONFIG, WEIGHTS, f32, 48,
                TESTER_BARS["E1 f32 tiled"], tiled_inference=True,
                test_lr_patch_stride=TILED_STRIDE)
    # the held-out slices are LR 16x12, one zero-padded 24x24 patch at the
    # config's patch size: the model sees 24x24, its training size, and
    # scores 2.3 dB above whole-slice SR, in the JAX tester as here
    d = tiled["scores"]["psnr"] - e1["scores"]["psnr"]
    log(f"tiled (stride {TILED_STRIDE}) against whole-slice: {d:+.4f} dB "
        f"(tol {TILED_TOL_DB} below)")
    if d < -TILED_TOL_DB:
        raise AssertionError(f"tiled row {d} dB below the whole-slice row")
    # 12x12 patches at stride 6 overlap, 4 a slice, in chunks of 128
    small = row("E1 f32 tiled 12/6", CONFIG, WEIGHTS, f32, 48,
                TESTER_BARS["E1 f32 tiled 12/6"], tiled_inference=True,
                patch_size=12, test_lr_patch_stride=6)
    d = small["scores"]["psnr"] - e1["scores"]["psnr"]
    log(f"tiled (patch 12, stride 6) against whole-slice: {d:+.4f} dB (tol "
        f"{TILED_TOL_DB})")
    if abs(d) > TILED_TOL_DB:
        raise AssertionError(f"tiled row {d} dB off the whole-slice row")
    row("HRL fine-tune", HRL_CONFIG, HRL_WEIGHTS, f32, 48,
        TESTER_BARS["HRL fine-tune"])
    row("RaGAN fine-tune 5k", GAN_CONFIG, GAN_WEIGHTS, f32, 48,
        TESTER_BARS["RaGAN fine-tune 5k"])
    row("RaGAN fine-tune 2 10k", GAN2_CONFIG, GAN2_WEIGHTS, f32, 48,
        TESTER_BARS["RaGAN fine-tune 2 10k"])
    return {"kernels": kern, "rows": rows}


@phase("SwinIR tester")
def swinir_tester_phase(data_dir: str, tmp: str, patients: dict,
                        live16) -> dict:
    """The C = 180 fast block with int8 qkv at one whole patient's
    windows against its plain version, then ``cli.test_main`` on the card
    for SwinIR-light (f32) and SwinIR-std (bf16, int8 qkv, as shipped)."""
    from rdst_tpu_torch.kernels import swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    blk = live16.model.layers[0].residual_group.blocks[0]
    kern = [_fast_block_at(blk, images, x_size, gen, live16.model.softmax,
                           frozenset({"qkv"}))
            for images, x_size in _tester_geometries(patients)]
    light = _tester_row("SwinIR-light", LIGHT_CONFIG, LIGHT_WEIGHTS,
                        data_dir, tmp, patients,
                        swin_block.fused_swin_block, 24,
                        TESTER_BARS["SwinIR-light"])
    std = _tester_row("SwinIR-std", SWINIR_CONFIG, SWINIR_WEIGHTS, data_dir,
                      tmp, patients, swin_block.run_fast_block, 36,
                      TESTER_BARS["SwinIR-std"])
    return {"kernels": kern, "rows": {"SwinIR-light": light,
                                      "SwinIR-std": std}}


@phase("W96 tester")
def w96_tester_phase(data_dir: str, tmp: str, patients: dict, live32,
                     live16) -> dict:
    """W96's f32 blocks (C = 96 and 192) and its RDSTB with int8 qkv at
    one whole patient's windows against their plain versions, then
    ``cli.test_main`` on the card for W96 in f32 (as shipped) and in bf16
    (mode rdstb, int8 qkv)."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    blocks = _rdst_blocks(live32.model)
    kern = {"f32": [], "rdstb": []}
    for images, x_size in _tester_geometries(patients):
        kern["f32"] += [_f32_block_at(blk, shift, images, x_size, gen)
                        for blk, shift in blocks[:2] + blocks[4:]]
        kern["rdstb"].append(_rdstb_at(live16.model.body[0], images, x_size,
                                       gen, live16.model.softmax,
                                       frozenset({"qkv"})))
    f32 = _tester_row("W96 f32", W96_CONFIG, W96_WEIGHTS, data_dir, tmp,
                      patients, swin_block.fused_swin_block, 48,
                      TESTER_BARS["W96 f32"])
    bf16 = _tester_row("W96 bf16", W96_CONFIG, W96_WEIGHTS, data_dir, tmp,
                       patients, rdstb_block.run_rdstb, 8,
                       TESTER_BARS["W96 bf16"], inference_dtype="bfloat16")
    # the config's int8 qkv costs 0.04 dB in the JAX kernels as here; the
    # same bf16 kernels without it hold the bf16-vs-f32 bar
    d = bf16["scores"]["psnr"] - f32["scores"]["psnr"]
    log(f"W96 bf16 (int8 qkv, as shipped) against f32: {d:+.4f} dB")
    plain16 = _tester_row("W96 bf16 without int8", W96_CONFIG, W96_WEIGHTS,
                          data_dir, tmp, patients, rdstb_block.run_rdstb, 8,
                          inference_dtype="bfloat16", pallas_quant="off")
    _versus_f32("W96 bf16 without int8", plain16, f32)
    return {"kernels": kern, "rows": {"W96 f32": f32, "W96 bf16": bf16,
                                      "W96 bf16 without int8": plain16}}


def run_w96(data_dir: str, tmp: str, patients: dict):
    """Phases 20-25, RDST-W96; returns (results, kernel rows)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import rdstb_block
    from rdst_tpu_torch.serving.export import LiveModel

    def paras(**kw):
        p = ParametersLoader(W96_CONFIG)
        p.set("well_trained_single_scale_model_g", W96_WEIGHTS)
        for k, v in kw.items():
            p.set(k, v)
        return p

    t0 = time.perf_counter()
    live32 = LiveModel(paras(), max_batch=64, device="cuda")
    live16 = LiveModel(paras(inference_dtype="bfloat16"), max_batch=64,
                       device="cuda")
    m32, m16 = live32.manifest, live16.manifest
    log(f"loaded {W96_CONFIG} + {W96_WEIGHTS} in f32 (routes "
        f"{m32['routes']}) and bf16 (kernel mode {m16['pallas_kernels']}, "
        f"softmax {m16['pallas_softmax']}, int8 {m16['pallas_quant']}) in "
        f"{time.perf_counter() - t0:.3f} s")
    if (m32["dtype"], m32["routes"]) != ("float32", ["fused_swin_block"] * 8):
        raise AssertionError(f"W96 f32 manifest {m32}")
    if (m16["dtype"], m16["pallas_kernels"], m16["pallas_quant"],
            m16["routes"]) != ("bfloat16", "rdstb", ["qkv"],
                               ["fused_rdstb"] * 8):
        raise AssertionError(f"W96 bf16 manifest {m16}")
    gemm = token_gemm_phase()
    kern = w96_kernel_phase(live32.model, live16.model)
    whole = w96_model_phase(live32, live16)
    serve32 = w96_serving_phase(live32)
    serve16 = w96_bf16_serving_phase(live16, rdstb_block.run_rdstb, 8,
                                     "bfloat16", SERVE_TOL_BF16)
    prof32 = w96_profile_phase(live32)
    prof16 = w96_bf16_profile_phase(
        live16, tuple(k for k, _ in STAGE_PHASES), "rdstb stage kernels")
    kern_train = w96_train_kernel_phase(live16.model)
    tester = w96_tester_phase(data_dir, tmp, patients, live32, live16)
    del live32, live16
    train = w96_train_phase(data_dir, tmp)
    kernels = [
        _row("fused_swin_block (W96 f32, C = 96/144/192)", "swin_block.cu",
             "rdst_tpu/kernels/swin_block.py:757", serve32["launches"],
             kern["f32"]),
        _row("fused_rdstb (W96, int8 qkv)", "rdstb_block.cu",
             "rdst_tpu/kernels/rdstb_block.py:334", serve16["launches"],
             kern["rdstb"]),
        _row("fused_swin_pair (W96, C = 96/144/192, int8 qkv)",
             "swin_pair.cu", "rdst_tpu/kernels/swin_block.py:1001",
             whole["pair"]["launches_per_forward"],
             [r for r in kern["pair"] if r["int8"]]),
    ] + _train_rows("fused_swin_pair_train (W96, C = 96)", "pair_train.cu",
                    "rdst_tpu/kernels/pair_train.py:293", kern_train, train)
    results = {"manifest": {"f32": m32, "bf16": m16}, "gemm": gemm,
               "train": {"kernel": kern_train, "step": train},
               "kernel": kern,
               "model": whole, "serving": {"f32": serve32, "bf16": serve16},
               "profile": {"f32": prof32, "bf16": prof16},
               "tester": tester}
    return results, kernels


def _row(name, source, replaces, launches, rs):
    """One kernel of the JSON line: per launch, averaged over the variants
    the main path runs."""
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


def _train_rows(name, source, replaces, kern_train, train):
    """The forward and backward rows of a train kernel at the main path's
    timed variant (max_abs_err: the output for the forward, the largest
    absolute error of any gradient for the backward; relative errors are
    logged)."""
    timed = [r for r in kern_train["variants"] if "ms" in r]
    parts = {
        "forward": ("ms", "plain_ms", "bound_ms", "bound_by",
                    train["forward_launches"], "out_abs_err"),
        "backward": ("bwd_ms", "plain_bwd_ms", "bwd_bound_ms",
                     "bwd_bound_by", train["backward_launches"],
                     "grad_abs_err"),
    }
    return [_row(f"{name} ({part})", source, replaces, launches,
                 [dict(max_abs_err=max(v[err] for v in kern_train["variants"]),
                       ms=r[ms], plain_ms=r[plain], bound_ms=r[bound],
                       bound_by=r[by]) for r in timed])
            for part, (ms, plain, bound, by, launches, err) in parts.items()]


def run_e1(data_dir: str, tmp: str, patients: dict):
    """Phases 3-13, RDST-E1; returns (results, kernel rows)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import rdstb_block
    from rdst_tpu_torch.serving.export import LiveModel

    paras = ParametersLoader(CONFIG)
    paras.set("well_trained_single_scale_model_g", WEIGHTS)
    t0 = time.perf_counter()
    live = LiveModel(paras, max_batch=64, device="cuda")
    log(f"loaded {CONFIG} + {WEIGHTS} on {live.device} in "
        f"{time.perf_counter() - t0:.3f} s (kernel mode "
        f"{live.manifest['pallas_kernels']}, softmax "
        f"{live.manifest['pallas_softmax']})")
    kern = kernel_phase(live.model)
    kern["wide"] = wide_kernel_phase()["variants"]
    whole = model_phase(live)
    serve = serving_phase(live)
    prof = profile_phase(live)

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
    prof16 = bf16_profile_phase(live16, ("rdstb_stage_kernel",
                                         "rdstb_conv_kernel"),
                                "rdstb stage kernels")
    kern_train = train_kernel_phase(live16.model)
    train = train_phase(data_dir, tmp)
    prof_train = train_profile_phase(train.pop("trainer"))
    finetune = {"seg": seg_finetune_phase(data_dir, tmp),
                "gan": gan_finetune_phase(data_dir, tmp),
                "bf16": finetune_bf16_phase(data_dir, tmp)}
    tester = e1_tester_phase(data_dir, tmp, patients, live, live16)

    main_softmax = live16.model.softmax
    kernels = [
        # averaged over the six (C, shift) variants that each run 8 times
        # in one forward: the main path's own mix at bucket 64
        _row("fused_swin_block", "swin_block.cu",
             "rdst_tpu/kernels/swin_block.py:757", serve["launches"],
             kern["variants"]),
        _row("fused_swin_block_fast", "swin_block_fast.cu",
             "rdst_tpu/kernels/swin_block.py:757",
             whole16["swin"]["launches_per_forward"],
             [r for r in kern16["block"] if r["softmax"] == main_softmax]),
        _row("fused_swin_pair", "swin_pair.cu",
             "rdst_tpu/kernels/swin_block.py:1001",
             whole16["pair"]["launches_per_forward"], kern16["pair"]),
        _row("fused_rdstb", "rdstb_block.cu",
             "rdst_tpu/kernels/rdstb_block.py:334", serve16["launches"],
             kern16["rdstb"]),
    ] + _train_rows("fused_swin_pair_train", "pair_train.cu",
                    "rdst_tpu/kernels/pair_train.py:293", kern_train, train)
    results = {"kernel": kern, "model": whole, "serving": serve,
               "profile": prof,
               "bf16": {"manifest": live16.manifest, "kernel": kern16,
                        "model": whole16, "serving": serve16,
                        "profile": prof16},
               "train": {"kernel": kern_train, "step": train,
                         "profile": prof_train},
               "finetune": finetune,
               "tester": tester}
    return results, kernels


def run_swinir(data_dir: str, tmp: str, patients: dict):
    """Phases 14-19, SwinIR-std; returns (results, kernel rows)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.serving.export import LiveModel

    def paras(**kw):
        p = ParametersLoader(SWINIR_CONFIG)
        p.set("well_trained_single_scale_model_g", SWINIR_WEIGHTS)
        for k, v in kw.items():
            p.set(k, v)
        return p

    t0 = time.perf_counter()
    live16 = LiveModel(paras(), max_batch=64, device="cuda")
    m = live16.manifest
    log(f"loaded {SWINIR_CONFIG} + {SWINIR_WEIGHTS} in "
        f"{time.perf_counter() - t0:.3f} s ({m['dtype']}, kernel mode "
        f"{m['pallas_kernels']}, softmax {m['pallas_softmax']}, int8 "
        f"{m['pallas_quant']}, routes {m['routes']})")
    if (m["dtype"], m["pallas_kernels"], m["pallas_softmax"],
            m["pallas_quant"]) != ("bfloat16", "swin", "clamp", ["qkv"]):
        raise AssertionError(f"SwinIR-std manifest {m}")
    shifts = {b.resolved_window(LR_HW)[1] for layer in live16.model.layers
              for b in layer.residual_group.blocks}
    log(f"block shifts at the build resolution: {sorted(shifts)}")
    if shifts != {0}:
        raise AssertionError("SwinIR-std blocks are built shifted")
    kern = swinir_kernel_phase(live16.model)
    live32 = LiveModel(paras(inference_dtype="float32",
                             pallas_kernels="off"), max_batch=8,
                       device="cuda")
    live_cpu = LiveModel(paras(), max_batch=8, device="cpu")
    whole = swinir_model_phase(live16, live32, live_cpu)
    del live32, live_cpu
    serve = swinir_serving_phase(live16, swin_block.run_fast_block, 36,
                                 "bfloat16", SERVE_TOL_BF16)
    prof = swinir_profile_phase(live16, tuple(k for k, _ in FAST_PHASES),
                                "fast block kernels")
    kern_train = block_train_kernel_phase(live16.model)
    tester = swinir_tester_phase(data_dir, tmp, patients, live16)
    del live16
    train = swinir_train_phase(data_dir, tmp)
    prof_train = train_profile_phase(train.pop("trainer"))
    kernels = [
        _row("fused_swin_block_fast (SwinIR-std, C = 180, int8 qkv)",
             "swin_block_fast.cu", "rdst_tpu/kernels/swin_block.py:757",
             serve["launches"],
             [r for r in kern["variants"] if r["softmax"] == "clamp"]),
    ] + _train_rows("fused_swin_block_train", "block_train.cu",
                    "rdst_tpu/kernels/block_train.py:307", kern_train, train)
    results = {"kernel": kern, "model": whole, "serving": serve,
               "profile": prof,
               "train": {"kernel": kern_train, "step": train,
                         "profile": prof_train},
               "tester": tester}
    return results, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--only", choices=("e1", "swinir", "w96"), default=None,
                    help="run the card and build phases and one model's "
                    "phases only (default: every phase)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = card_phase()
    libs = build_phase()
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "libs": libs}
    kernels = []
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = _make_corpus(tmp)
        patients = _tester_patients(data_dir)
        log(f"held-out patients: {dict(zip(patients, _images(patients)))} "
            "slices")
        if args.only in (None, "e1"):
            results["e1"], rows = run_e1(data_dir, tmp, patients)
            kernels += rows
        if args.only in (None, "swinir"):
            results["swinir"], rows = run_swinir(data_dir, tmp, patients)
            kernels += rows
        if args.only in (None, "w96"):
            results["w96"], rows = run_w96(data_dir, tmp, patients)
            kernels += rows
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
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
