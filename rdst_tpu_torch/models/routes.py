"""Kernel routes of a built model, decided once (counterpart of the JAX
package's trace-time gates in ``rdst_tpu/nn/swin.py`` and
``rdst_tpu/models/rdst.py``).

Any model made of :class:`~rdst_tpu_torch.nn.swin.BasicLayer` s takes its
routes here. It names its route units (``model.route_units()``: the
RDSTBs of RDST, the RSTBs of SwinIR), its ``dtype`` and, for training,
the resolution its training patches have (``model.train_resolution``).

* :func:`set_kernel_mode`: the serving routes. float32: every kernel mode
  runs each Swin block on the f32 block kernel (int8 is dropped, as the
  JAX precise path drops it). bfloat16: 'swin'/'pack' run each block on
  the fast block kernel, 'pair' each DSTL pair of RDST on the pair
  kernel, 'rdstb' each RDSTB on the RDSTB kernel, all three with int8
  operands for the groups ``quant`` asks for (any subset of 'qkv',
  'mlp', 'proj', 'conv'; 'conv' is the RDSTB's, the blocks take the
  other three). A unit the mode's kernel cannot take raises and names
  the mode to choose; nothing falls back quietly.
* :func:`set_train_mode`: the bf16 training route of each layer, by the
  JAX package's admission rules (``kernels.block_train``): a layer whose
  pair fits the train-pair kernel runs on it (``'pair'``, the default),
  else each of its blocks on the single-block train kernel; ``'block'``
  puts every block on the single-block kernel (the JAX package's forced
  A/B). ``model.train_routes`` counts the pairs and blocks each route
  takes.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from rdst_tpu_torch.nn.layers import BF16
from rdst_tpu_torch.nn.swin import (BasicLayer, SwinTransformerBlock,
                                    set_block_kernels)


def _layers(unit: nn.Module):
    return [m for m in unit.modules() if isinstance(m, BasicLayer)]


def set_kernel_mode(model: nn.Module, mode: str, softmax: str = "",
                    quant=frozenset()) -> list:
    """Route ``model``'s blocks for kernel mode ``mode`` ('' for the plain
    path) at the model's dtype, with the bf16 kernels' ``softmax``
    variant and int8 groups ``quant``; sets ``model.kernel_mode``,
    ``model.softmax``, ``model.quant`` and ``model.routes`` (the kernel
    each route unit runs) and returns the routes. A model with no route
    unit reads as the plain path: mode and softmax '', no int8 group."""
    from rdst_tpu_torch.kernels.quant import check_ported
    from rdst_tpu_torch.kernels.swin_block import softmax_code
    from rdst_tpu_torch.kernels.window_attention import KERNEL_MODES

    if mode and mode not in KERNEL_MODES:
        raise ValueError(f"kernel mode {mode!r}: expected one of "
                         f"{KERNEL_MODES} or ''")
    if not model.route_units():  # no kernel to route (EDSR, MetaSR)
        mode, softmax, quant = "", "", frozenset()
    bf16 = model.dtype == BF16
    check_ported(quant)  # raises on a group it does not know
    if bf16:
        softmax_code(softmax)  # raises on a variant the kernels lack
        quant = frozenset(quant or ()) if mode else frozenset()
    else:
        quant = frozenset()  # int8 rides the bf16 fast path only
    set_block_kernels(model, False)
    for m in model.modules():
        if isinstance(m, BasicLayer):
            m.use_pair = False
            m.quant = frozenset()
        if isinstance(m, SwinTransformerBlock):
            m.quant = frozenset()
            m.pack = 1
        if hasattr(m, "use_rdstb"):
            m.use_rdstb = False
            m.quant = frozenset()
        if hasattr(m, "softmax"):
            m.softmax = softmax
    routes = []
    for i, (kind, unit) in enumerate(model.route_units()):
        where = f"{kind} {i}"
        if not mode:
            routes.append("plain")
        elif not bf16 or mode in ("swin", "pack"):
            for blk in unit.modules():
                if not isinstance(blk, SwinTransformerBlock):
                    continue
                why = (blk.fast_unsupported() if bf16
                       else blk.f32_unsupported())
                if why:
                    kind_k = "fast" if bf16 else "f32"
                    raise ValueError(
                        f"{where}: the {kind_k} block kernel cannot run it "
                        f"({why}); build with pallas_kernels='off'")
                blk.quant = quant
                # the JAX package pairs windows in 'pack' mode at C <= 64,
                # which changes the windows of a dynamic int8 scale
                blk.pack = 2 if mode == "pack" and blk.dim <= 64 else 1
            set_block_kernels(unit, True)
            routes.append("fused_swin_block")
        elif not hasattr(unit, "rdstb_unsupported"):
            raise ValueError(
                f"{where}: mode {mode!r} runs DSTL pairs and RDSTBs of RDST; "
                "the pair route of a plain Swin stack is decided by the "
                "image size in the JAX package, which the port does not "
                "copy: build with pallas_kernels='swin'")
        elif mode == "pair":
            for layer in _layers(unit):
                why = layer.pair_unsupported(quant)
                if why:
                    raise ValueError(
                        f"{where}: the pair kernel cannot run it ({why}); "
                        "build with pallas_kernels='swin' or 'off'")
                layer.use_pair = True
                layer.quant = quant
            routes.append("fused_swin_pair")
        else:
            why = unit.rdstb_unsupported(quant)
            if why:
                raise ValueError(
                    f"{where}: the RDSTB kernel cannot run it ({why}); "
                    "build with pallas_kernels='pair' or 'off'")
            unit.use_rdstb = True
            unit.quant = quant
            routes.append("fused_rdstb")
    model.kernel_mode, model.softmax, model.routes = mode, softmax, routes
    model.quant = quant
    return routes


def set_train_mode(model: nn.Module, mode: str) -> str:
    """Decide the training route of ``model`` once (``model.train_mode``,
    returned; ``model.train_routes``). float32 trains on the plain
    modules whatever ``mode`` says (the JAX train kernels need bf16).
    bfloat16: 'pair' runs each layer's pairs on the train-pair kernels
    where the JAX package's pair rule admits them, else its blocks on the
    single-block train kernel; 'block' runs every block on the
    single-block kernel; a layer that neither takes raises, naming
    ``pallas_train='off'``; '' runs the plain bf16 modules."""
    layers = [m for m in model.modules() if isinstance(m, BasicLayer)]
    for layer in layers:
        layer.use_pair_train = False
        for blk in layer.blocks:
            blk.use_block_train = False
    if model.dtype != BF16:
        mode = ""
    if mode not in ("", "pair", "block"):
        raise ValueError(f"pallas_train={mode!r}: expected 'pair', 'block' "
                         "or ''")
    counts: Dict[str, int] = {"pair": 0, "block": 0}
    if mode:
        res = tuple(model.train_resolution)
        for layer in layers:
            route = layer.train_route(mode, res, model.softmax)
            if route == "pair":
                layer.use_pair_train = True
                counts["pair"] += len(layer.blocks) // 2
            else:
                for blk in layer.blocks:
                    blk.use_block_train = True
                counts["block"] += len(layer.blocks)
    model.train_mode, model.train_routes = mode, counts
    return mode
