"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asking
for ``cuda`` on a machine without a usable card raises: nothing quietly
carries on on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the ``torch.device`` for ``device`` ('cuda', 'cuda:N' or
    'cpu'). For a CUDA device this also pins float32 numerics: TF32 off
    for matmuls (``torch.backends.cuda.matmul.allow_tf32 = False``) and
    for cuDNN convolutions (``torch.backends.cudnn.allow_tf32 = False``),
    so an f32 model computes in f32 on the card as it does on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev


# -- tables cached on a device ---------------------------------------------

_held = threading.local()
_tables = []


def device_table(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that makes a table
    on a device (an index, a mask, a plan's arrays). Every call, a hit or a
    miss, also adds what it returns to each :func:`held_tables` list open in
    the calling thread: a CUDA graph keeps raw pointers to the tables its
    capture read, so it must keep them alive once the cache evicts them."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            out = cached(*args, **kwargs)
            for held in getattr(_held, "lists", ()):
                held.append(out)
            return out

        call.cache_clear, call.cache_info = cached.cache_clear, \
            cached.cache_info
        _tables.append(call)
        return call

    return wrap


@contextlib.contextmanager
def held_tables():
    """Collect, in a list, every table a :func:`device_table` function
    returns in this thread while the context is open."""
    held = []
    lists = _held.__dict__.setdefault("lists", [])
    lists.append(held)
    try:
        yield held
    finally:
        lists.remove(held)


def clear_device_tables() -> None:
    """Empty every :func:`device_table` cache (what a graph holds stays)."""
    for fn in _tables:
        fn.cache_clear()
