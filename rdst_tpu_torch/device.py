"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asking
for ``cuda`` on a machine without a usable card raises: nothing quietly
carries on on the CPU.
"""

from __future__ import annotations

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
