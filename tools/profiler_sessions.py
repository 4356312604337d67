"""Which kernel records a torch.profiler session loses, and where.

Runs ``chip_smoke.py`` (any ``--only`` names it takes) with its
``_kernels_per_call`` wrapped: before each count, the same call is
profiled three times in each of three ways (as the script does, with CUDA
activity alone, and without a wait before the launches), each session
padded by 32 spin kernels before and after five calls. For every session
it records the kernels in start order as runs (``s`` a spin, ``m`` a
memory set or copy, ``k`` any other kernel: ``s29 m1 k8 ... s32`` lost
three leading spins) and prints them as one JSON line starting ``SESSIONS``.
Needs a CUDA card and the weights the chosen phases read::

    python3 tools/profiler_sessions.py --only int8
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

PAD = 32
SESSIONS = []


def runs(seq: str) -> str:
    """'sssmk' -> 's3 m1 k1'."""
    out, i = [], 0
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j] == seq[i]:
            j += 1
        out.append(f"{seq[i]}{j - i}")
        i = j
    return " ".join(out)


def kind(name: str) -> str:
    low = name.lower()
    if "spin_kernel" in low:
        return "s"
    return "m" if "memset" in low or "memcpy" in low else "k"


def logged(count):
    def wrapped(call, iters: int = 5):
        call()
        torch.cuda.synchronize()
        for way in ("as the script", "cuda activity only", "no wait"):
            acts = [ProfilerActivity.CUDA] if way == "cuda activity only" \
                else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            for _ in range(3):
                with profile(activities=acts) as prof:
                    if way != "no wait":
                        time.sleep(0.05)
                    for _ in range(PAD):
                        torch.cuda._sleep(1000)
                    for _ in range(iters):
                        call()
                    for _ in range(PAD):
                        torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                ks = sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
                SESSIONS.append({"way": way, "kernels": runs(
                    "".join(kind(e.name) for e in ks))})
        out = count(call, iters)
        SESSIONS.append({"count": {k: v for k, v in out.items()
                                   if k != "names"}})
        return out
    return wrapped


if __name__ == "__main__":
    chip_smoke._kernels_per_call = logged(chip_smoke._kernels_per_call)
    rc = chip_smoke.main(sys.argv[1:])
    print("SESSIONS", json.dumps(SESSIONS), flush=True)
    sys.exit(rc)
