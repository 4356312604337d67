"""Tracing and timing utilities (counterpart of
``rdst_tpu/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` session over the enclosed
  block (the CPU, and the card where there is one), written to
  ``logdir`` as a Chrome trace (``trace.json``, Perfetto reads it);
* ``Throughput``: steps/s and items/s with the first ``warmup_steps``
  steps excluded (host wall clock: a step that only queues work on the
  card counts when it is queued);
* ``time_fn``: the median time of a call, by CUDA events around each call
  when its result lies on a CUDA device, else by the wall clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity where a card is available); on exit write the
    Chrome trace ``{logdir}/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Throughput:
    """steps/s and items/s counter with warmup exclusion: the clock starts
    at the ``warmup_steps``-th step, and the steps and items after it
    count."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = max(1, warmup_steps)  # 0 would never start the clock
        self.steps = 0
        self.items = 0
        self._t0 = None

    def step(self, n_items: int = 1):
        self.steps += 1
        if self.steps == self.warmup_steps:
            self._t0 = time.time()
            self.items = 0
        elif self.steps > self.warmup_steps:
            self.items += n_items

    @property
    def elapsed(self) -> float:
        return time.time() - self._t0 if self._t0 else 0.0

    def report(self) -> dict:
        el = max(self.elapsed, 1e-9)
        return {
            "steps": self.steps,
            "items_per_sec": self.items / el,
            "steps_per_sec": max(self.steps - self.warmup_steps, 0) / el,
        }


def _device_of(out):
    """The CUDA device of the first tensor in ``out`` (a tensor, or a
    list / tuple / dict of them), else None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for v in items:
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn(*args)`` in seconds over ``iters`` calls after
    ``warmup`` (and one untimed call that finds where the result lies). A
    call whose result lies on a CUDA device is timed by CUDA events on that
    device's current stream (the device's time from the call's first to
    its last queued work); any other by the wall clock around the call."""
    dev = _device_of(fn(*args))
    times = []
    for i in range(warmup + iters):
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args)
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args)
            dt = time.perf_counter() - t0
        if i >= warmup:
            times.append(dt)
    times.sort()
    return times[len(times) // 2]
