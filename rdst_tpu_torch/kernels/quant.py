"""int8 matmul operands of the fast Swin block (counterpart of the int8
option of ``rdst_tpu/kernels/swin_block.py``: ``_QCLIP``/``_QX`` :132-133,
``_quant_rows`` :249, ``quantize_weight`` :600, ``mm_quant_groups``
:618 and the ``qkv`` part of ``mm_quant_extras`` :636).

The JAX package's ``pallas_quant='qkv'`` runs the block's qkv product on
int8 operands: the weight per output channel (symmetric, amax / 127), the
activations -- LN1's output, unit variance by construction -- at a
static step of 4 sigma / 127. The product's int32 sums are exact, so the
only roundings are the two quantizations (half to even, as ``jnp.round``
and ``torch.round`` both round) and the f32 epilogue
``y = int32(xq @ wq) * ws + bqkv``. The other groups (``mlp``, ``proj``,
``conv``) are not ported and raise where they are asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

QCLIP = 4.0
QX = 127.0 / QCLIP  # 31.75: activation steps per unit of normalized input
PORTED_GROUPS = frozenset({"qkv"})
MM_GROUPS = frozenset({"qkv", "mlp", "proj"})


class QkvQuant(NamedTuple):
    """int8 qkv operands of one block, in the JAX layout."""
    wq: torch.Tensor  # (C, 3C) int8
    ws: torch.Tensor  # (3C,) float32: the weight step times 1 / QX


def mm_quant_groups(quant) -> frozenset:
    """The groups a Swin-block kernel takes (``mm_quant_groups``: 'conv'
    belongs to the RDSTB kernel only)."""
    return frozenset(quant or ()) & MM_GROUPS


def check_ported(quant) -> frozenset:
    """``mm_quant_groups(quant)``, raising on a group the port lacks."""
    groups = mm_quant_groups(quant)
    missing = sorted(frozenset(quant or ()) - PORTED_GROUPS)
    if missing:
        raise NotImplementedError(
            f"pallas_quant {missing}: only the 'qkv' int8 group is ported; "
            "int8 'mlp', 'proj' and 'conv' operands are not")
    return groups


def quantize_weight(w: torch.Tensor, act_step: float = 1.0):
    """``quantize_weight``: per-output-channel symmetric int8 of a (in,
    out) weight; returns (wq int8 (in, out), ws float32 (out,)) with the
    activation step folded into ws, so ``y = (xq @ wq) * ws + b``."""
    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-30)
    s = amax / 127.0
    wq = torch.clamp(torch.round(w / s), -127.0, 127.0).to(torch.int8)
    return wq, (s * act_step).to(torch.float32).reshape(-1)


def quant_rows(xf: torch.Tensor, s: float) -> torch.Tensor:
    """``_quant_rows``: float32 rows -> int8 at static scale s (one
    round/clip pass, round half to even)."""
    return torch.clamp(torch.round(xf * s), -127.0, 127.0).to(torch.int8)


def qkv_quant(wqkv_folded: torch.Tensor) -> QkvQuant:
    """The qkv part of ``mm_quant_extras`` for one block: from the folded
    qkv weight in the compute dtype (bf16), as the JAX wrapper hands it
    over."""
    wq, ws = quantize_weight(wqkv_folded, act_step=1.0 / QX)
    return QkvQuant(wq, ws)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product, as float32 (every sum stays
    below 2^24 for C <= 1040, so float64 products round nowhere)."""
    return (xq.double() @ wq.double()).float()
