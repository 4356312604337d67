"""A bf16 training step of the PyTorch port on the card: its rate, device
time and kernel launches, to compare two trees.

    python tools/train_step_profile.py --root DIR [--config CFG] [--out F]

Imports ``rdst_tpu_torch`` from ``DIR`` (a checkout of any commit of the
port), makes the 20-phantom corpus of ``rdst_tpu_torch.data.synthetic``
in a temporary directory, builds the trainer of ``CFG`` (default: the
shipped bf16 RDST-E1 recipe, ``config_files/rdst_e1_100k_oasis20_x4.ini``;
``training_dtype='bfloat16'`` is set) and, on one batch drawn from a fixed
numpy seed, after 3 warm-up steps: the steps/s on the wall clock over 10
steps queued back to back, then one step under ``torch.profiler``: the
device's busy time and idle share of the step's wall time, the kernel
launches (memory sets and copies apart), and the device time and launches
of the train pair's forward kernel and of the shared backward's kernels.
Prints one JSON line, and writes it to ``F`` when given. Needs a CUDA
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

E1_TRAIN = "config_files/rdst_e1_100k_oasis20_x4.ini"
SEED, WARM, STEPS = 6, 3, 10


def profile_step(root: str, config: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)  # configs by their repository paths
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rdst_tpu_torch.cli import build_trainer
    from rdst_tpu_torch.data import synthetic
    from rdst_tpu_torch.runners.trainer import pin_batch

    if not torch.cuda.is_available():
        raise SystemExit("train_step_profile: needs a CUDA card")
    tmp = tempfile.mkdtemp()
    data_dir = os.path.join(tmp, "OASIS", "example20")
    synthetic.make_oasis_example(
        data_dir,
        patient_ids=tuple(f"OAS1_{i:04d}_MR1" for i in range(1, 21)))
    trainer = build_trainer([
        "--config-file", config, f"data_folder='{data_dir}'",
        f"output_dir='{os.path.join(tmp, 'out')}'",
        "epochs_in_total={'WarmUP': 1}", "check_every=10",
        "quick_eva_num_samples=8", "eva_metrics='psnr ssim'",
        "verbose=False", "training_dtype='bfloat16'"])
    trainer.setup()
    batch = pin_batch(trainer.ds_train.sample(np.random.default_rng(SEED)))
    for _ in range(WARM):
        trainer.train_step(batch, "WarmUP")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        trainer.train_step(batch, "WarmUP")
    torch.cuda.synchronize()
    steps_per_s = STEPS / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, "WarmUP")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = launches = 0.0
    parts = {"train_pair_forward": [0.0, 0], "backward": [0.0, 0]}
    for e in prof.key_averages():
        t = float(e.self_device_time_total or 0.0) / 1e3
        name = e.key.lower()
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        busy += t
        if "memset" in name or "memcpy" in name:
            continue
        launches += e.count
        part = ("train_pair_forward" if "pair_train_fwd" in name else
                "backward" if ("trainblk::" in name or "tokpar::" in name)
                else None)
        if part:
            parts[part][0] += t
            parts[part][1] += e.count
    return {"root": root, "config": config,
            "device": torch.cuda.get_device_name(0),
            "steps_per_s": steps_per_s, "wall_ms": wall_ms,
            "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "kernel_launches": launches,
            "parts": {k: {"device_ms": v[0], "launches": v[1]}
                      for k, v in parts.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--config", default=E1_TRAIN)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out) if args.out else None
    res = profile_step(args.root, args.config)
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
