"""int8 operands of the fast Swin block, the pair and the RDSTB
(counterpart of the int8 option of ``rdst_tpu/kernels/swin_block.py``:
``_QCLIP``/``_QX`` :132-133, ``_quant_rows`` :249, ``_quant_dyn`` :254,
``quantize_weight`` :600, ``mm_quant_groups`` :618, ``mm_quant_extras``
:636, and of ``rdst_tpu/kernels/rdstb_block.py``'s conv group :184-189,
:482-487).

The JAX package's ``pallas_quant`` (any comma list of ``qkv``, ``mlp``,
``proj``, ``conv``, or ``all``) runs these products on int8 operands:

* ``qkv``: the block's qkv product; its input, LN1's output (unit
  variance by construction), at a static step of 4 sigma / 127;
* ``mlp``: fc1 on LN2's output at the same static step, and fc2 on the
  tanh GELU's float32 output at a dynamic scale;
* ``proj``: the attention projection on the float32 attention output at
  a dynamic scale;
* ``conv``: the RDSTB's 3x3 conv on its bf16 dense concat x0 | feats at a
  dynamic scale, the nine taps summed in int32 and dequantized once.

Every weight is quantized per output channel (symmetric, amax / 127) from
the folded bf16 weight, the activation step folded into the scale row, so
``y = int32(xq @ wq) * ws + b`` (for a dynamic scale ``ws * dq`` first).
The int32 sums are exact, so the only roundings are the quantizations
(half to even, as ``jnp.round`` and ``torch.round`` both round) and the
float32 epilogues.

A dynamic scale is ``max |x|`` over the whole value of one Pallas program
of the JAX kernel, and a program holds the windows its wrapper's grid
rule gives it: :func:`block_group_windows`, :func:`pair_group_windows`
and :func:`rdstb_group_images` are those rules (own copies of the JAX
package's VMEM models): a call's scale groups are its consecutive runs of
that many windows or images. The images that share a group share a
scale, so in either package an image's output depends on which images
are batched with it.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import torch

QCLIP = 4.0
QX = 127.0 / QCLIP  # 31.75: activation steps per unit of normalized input
GROUPS = ("qkv", "mlp", "proj", "conv")
PORTED_GROUPS = frozenset(GROUPS)
MM_GROUPS = frozenset({"qkv", "mlp", "proj"})
# the JAX package's images a program (``RDST_TPU_PALLAS_IPP``): 2 for the
# fast block and the pair (``nn/swin.py`` :405, :584), 1 for the RDSTB
# (``models/rdst.py`` :296); the port reads its own env name
ENV_IPP = "RDST_TORCH_IPP"
DEFAULT_IPP = {"block": 2, "pair": 2, "rdstb": 1}
VMEM_BUDGET = 15.5 * 2**20  # ``_VMEM_BUDGET``


class QkvQuant(NamedTuple):
    """int8 qkv operands of one block, in the JAX layout."""
    wq: torch.Tensor  # (C, 3C) int8
    ws: torch.Tensor  # (3C,) float32: the weight step times 1 / QX


class MlpQuant(NamedTuple):
    """int8 fc1 and fc2 operands of one block, in the JAX layout."""
    w1q: torch.Tensor  # (C, H) int8, from the folded w1
    w1s: torch.Tensor  # (H,) float32: the weight step times 1 / QX
    w2q: torch.Tensor  # (H, C) int8
    w2s: torch.Tensor  # (C,) float32: the weight step (dynamic input)


class ProjQuant(NamedTuple):
    """int8 projection operands of one block, in the JAX layout."""
    wq: torch.Tensor  # (C, C) int8
    ws: torch.Tensor  # (C,) float32: the weight step (dynamic input)


class ConvQuant(NamedTuple):
    """int8 operands of the RDSTB's conv."""
    wq: torch.Tensor  # (9*C_cat, C0) int8, tap-major rows
    ws: torch.Tensor  # (C0,) float32: the weight step (dynamic input)


def mm_quant_groups(quant) -> frozenset:
    """The groups a Swin-block kernel takes (``mm_quant_groups``: 'conv'
    belongs to the RDSTB kernel only)."""
    return frozenset(quant or ()) & MM_GROUPS


def check_ported(quant) -> frozenset:
    """``mm_quant_groups(quant)``, raising on a group the port does not
    know."""
    unknown = sorted(frozenset(quant or ()) - PORTED_GROUPS)
    if unknown:
        raise ValueError(f"pallas_quant: unknown int8 groups {unknown} "
                         f"(expected a subset of {list(GROUPS)})")
    return mm_quant_groups(quant)


def quantize_weight(w: torch.Tensor, act_step: float = 1.0):
    """``quantize_weight``: per-output-channel symmetric int8 of a (in,
    out) weight; returns (wq int8 (in, out), ws float32 (out,)) with the
    activation step folded into ws, so ``y = (xq @ wq) * ws + b``."""
    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-30)
    s = amax / 127.0
    wq = torch.clamp(torch.round(w / s), -127.0, 127.0).to(torch.int8)
    return wq, (s * act_step).to(torch.float32).reshape(-1)


def quant_rows(xf: torch.Tensor, s) -> torch.Tensor:
    """``_quant_rows``: float32 rows -> int8 at scale s (a number, or a
    float32 tensor that broadcasts against the rows); one round/clip
    pass, round half to even."""
    return torch.clamp(torch.round(xf * s), -127.0, 127.0).to(torch.int8)


def quant_dyn(xf: torch.Tensor, groups: int = 1):
    """``_quant_dyn`` over each of ``groups`` equal leading slices of xf
    (float32; one slice is one JAX program's value): ``amax = max(max |x|,
    1e-30)``, the rows quantized at ``127 / amax``; returns (int8 of xf's
    shape, the dequant step ``amax * (1 / 127)`` per group, float32
    (groups,))."""
    f32 = torch.float32
    flat = xf.to(f32).reshape(groups, -1)
    amax = torch.clamp(flat.abs().amax(dim=1, keepdim=True), min=1e-30)
    s = torch.full_like(amax, 127.0) / amax
    q = quant_rows(flat, s).reshape(xf.shape)
    return q, (amax * torch.tensor(1.0 / 127.0, dtype=f32)).reshape(-1)


def qkv_quant(wqkv_folded: torch.Tensor) -> QkvQuant:
    """The qkv part of ``mm_quant_extras`` for one block: from the folded
    qkv weight in the compute dtype (bf16), as the JAX wrapper hands it
    over."""
    wq, ws = quantize_weight(wqkv_folded, act_step=1.0 / QX)
    return QkvQuant(wq, ws)


def mlp_quant(w1_folded: torch.Tensor, w2: torch.Tensor) -> MlpQuant:
    """The mlp part of ``mm_quant_extras``: fc1 from the folded bf16 w1
    (LN2's affine in it) with the static activation step, fc2 from the
    bf16 w2 with step 1 (its input's step is dynamic)."""
    w1q, w1s = quantize_weight(w1_folded, act_step=1.0 / QX)
    w2q, w2s = quantize_weight(w2, act_step=1.0)
    return MlpQuant(w1q, w1s, w2q, w2s)


def proj_quant(wproj: torch.Tensor) -> ProjQuant:
    """The proj part of ``mm_quant_extras``: the bf16 projection weight,
    step 1."""
    return ProjQuant(*quantize_weight(wproj, act_step=1.0))


def conv_quant(wc_rows: torch.Tensor) -> ConvQuant:
    """The conv group of ``_fused_rdstb_impl``: the tap-major (9*C_cat,
    C0) bf16 rows quantized per output channel, step 1."""
    return ConvQuant(*quantize_weight(wc_rows, act_step=1.0))


class BlockQuant(NamedTuple):
    """One block's int8 operands by group (None where the group is off)."""
    qkv: Optional[QkvQuant] = None
    mlp: Optional[MlpQuant] = None
    proj: Optional[ProjQuant] = None


def block_quant(p, groups) -> BlockQuant:
    """``mm_quant_extras`` for one block's folded params (``FastParams``:
    wqkv, w1 folded and rounded to bf16; wproj, w2 bf16)."""
    groups = mm_quant_groups(groups)
    return BlockQuant(qkv_quant(p.wqkv) if "qkv" in groups else None,
                      mlp_quant(p.w1, p.w2) if "mlp" in groups else None,
                      proj_quant(p.wproj) if "proj" in groups else None)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product, as float32 (every sum of 127^2
    terms stays below 2^53 in float64; the result is exact below 2^24,
    which K <= 1040 keeps)."""
    return (xq.double() @ wq.double()).float()


# --------------------------------------------------------------------------
# The scale groups: the JAX wrappers' grid rules
# --------------------------------------------------------------------------

def _pad128(v: int) -> int:
    return -(-v // 128) * 128


def divisors_desc(nw: int) -> List[int]:
    """``_divisors_desc``: the divisors of nw, largest first."""
    return [d for d in range(nw, 0, -1) if nw % d == 0]


def images_per_program(kind: str) -> int:
    """The images a JAX program would take for ``kind`` ('block', 'pair'
    or 'rdstb'): ``RDST_TORCH_IPP`` when set (``RDST_TPU_PALLAS_IPP``'s
    counterpart), else the JAX package's default for that kernel."""
    raw = os.environ.get(ENV_IPP, "").strip()
    return int(raw) if raw else DEFAULT_IPP[kind]


def vmem_estimate(t, n, c, nh, hidden, nw, es=2, softmax: str = "") -> float:
    """``_vmem_estimate(..., fast=True)`` (the int8 groups ride the fast
    path only); ``softmax`` stands for ``RDST_TPU_PALLAS_SOFTMAX``."""
    from rdst_tpu_torch.kernels.block_train import vmem_estimate as ve

    return ve(t, n, c, nh, hidden, nw, es, True, softmax)


def rdstb_vmem_estimate(t, n, c0, growth, nb, nh, hidden_ratio, es=2,
                        nw=None, softmax: str = "") -> float:
    """``_rdstb_vmem_estimate``: the widest DSTL's block estimate plus a
    share of everything else resident around it."""
    pad = _pad128
    nw = t if nw is None else nw
    cmax = c0 + growth * (nb - 1)
    ccat = c0 + growth * nb
    widest = vmem_estimate(t, n, cmax, nh, int(cmax * hidden_ratio), nw, es,
                           softmax)
    feats = t * n * (pad(c0) + nb * pad(growth)) * es
    relayout = 3 * t * n * pad(cmax) * es
    cat = 2 * t * n * pad(ccat) * es
    conv_shift = 2 * t * n * pad(ccat) * es
    conv_acc = t * n * pad(c0) * 4
    conv_w = 9 * ccat * pad(c0) * es
    biases = (nb - 1) * nw * n * pad(nh * n) * es
    weights2 = 2 * sum(
        (3 * ci * pad(ci) + ci * pad(ci)
         + 2 * ci * pad(int(ci * hidden_ratio))) * es
        for ci in (c0 + growth * i for i in range(nb)))
    return widest + 0.12 * (weights2 + feats + relayout + cat + conv_shift
                            + conv_acc + conv_w + biases)


def block_group_windows(bnw: int, nw: int, n: int, c: int, nh: int,
                        hidden: int, bias_windows: int, softmax: str = "",
                        pack: int = 1) -> int:
    """Windows one program of ``fused_swin_block`` takes (its grid step
    ``t``, :863-887): whole images when one image fits the budget, up to
    :func:`images_per_program` of them (fewer while they do not divide
    the batch or fit), else the largest window chunk t | nW that fits.
    ``bias_windows``: nW for a per-window bias, 1 for a shared one.
    ``pack=2`` (the 'pack' mode at C <= 64) pairs windows first, as the
    JAX wrapper does where it can, and returns the unpacked windows."""
    if pack == 2 and nw % 2 == 0 and bnw % 2 == 0 and any(
            vmem_estimate(d, n, 2 * c, 2 * nh, 2 * hidden, d, 2, softmax)
            <= VMEM_BUDGET for d in divisors_desc(nw // 2)):
        return 2 * block_group_windows(
            bnw // 2, nw // 2, n, 2 * c, 2 * nh, 2 * hidden,
            1 if bias_windows == 1 else nw // 2, softmax)

    def fits(t, bw):
        return vmem_estimate(t, n, c, nh, hidden, bw, 2, softmax) \
            <= VMEM_BUDGET

    bw = bias_windows
    if fits(nw, bw):
        ipp = max(1, images_per_program("block"))
        while ipp > 1 and (bnw % (nw * ipp) != 0 or not fits(nw * ipp, bw)):
            ipp -= 1
        return nw * ipp
    for d in divisors_desc(nw):
        if fits(d, min(bw, d)):
            return d
    raise ValueError(f"no window chunk of nW={nw} fits the JAX kernel's "
                     f"budget at C={c}, {nh} heads")


def pair_group_windows(bnw: int, nw: int, n: int, c: int, nh: int,
                       hidden: int, softmax: str = "") -> int:
    """Windows one program of ``fused_swin_pair`` takes (:1057-1062):
    :func:`images_per_program` whole images, fewer while they do not
    divide the batch or the pair's estimate passes the budget."""
    from rdst_tpu_torch.kernels.block_train import pair_vmem_estimate

    ipp = max(1, images_per_program("pair"))
    while ipp > 1 and (bnw % (nw * ipp) != 0 or pair_vmem_estimate(
            nw * ipp, n, c, nh, hidden, nw, 2, softmax) > VMEM_BUDGET):
        ipp -= 1
    return nw * ipp


def rdstb_group_images(b: int, nw: int, n: int, c0: int, growth: int,
                       nb: int, nh: int, hidden_ratio: float,
                       softmax: str = "") -> int:
    """Images one program of ``fused_rdstb`` takes (:402-406):
    :func:`images_per_program`, fewer while they do not divide the batch
    or the RDSTB's estimate passes the budget."""
    ipp = max(1, images_per_program("rdstb"))
    while ipp > 1 and (b % ipp != 0 or rdstb_vmem_estimate(
            nw * ipp, n, c0, growth, nb, nh, hidden_ratio, 2, nw,
            softmax) > VMEM_BUDGET):
        ipp -= 1
    return ipp
