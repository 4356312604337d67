"""Attention-logit audit (counterpart of ``rdst_tpu/kernels/logit_audit.py``):
the measurement behind ``pallas_softmax='auto'``.

The clamp softmax of the bf16 kernels (exp(min(s, 60)), no max) is only
sound while trained logits stay bounded, so ``auto`` picks it only for a
checkpoint whose audited max attention logit is under the margin. This
module measures that bound: the model runs once on its plain modules
(every route off, as the JAX probe runs the XLA module path) in eval mode
without gradients, every ``WindowAttention`` keeps its max logit after
the scale, the relative-position bias and the shift mask (the value the
kernels clamp), and the max over all of them is returned. The trainer
probes at every quick evaluation, stamps ``attn_logit_max`` into the
snapshot's stats sidecar, and escalates to the stable softmax once the
bound reaches the margin.
"""

from __future__ import annotations

from typing import Optional

import torch


def measure_logit_bound(model, x: torch.Tensor) -> Optional[float]:
    """Max attention logit of ``model`` on ``x`` (NHWC LR), on the plain
    path; None for a model without window attention. The model's
    routes, mode and audit flags are restored afterwards."""
    from rdst_tpu_torch.models.rdst import set_kernel_mode
    from rdst_tpu_torch.nn.swin import WindowAttention

    attns = [m for m in model.modules() if isinstance(m, WindowAttention)]
    if not attns:
        return None
    mode, softmax = model.kernel_mode, model.softmax
    was_training = model.training
    for a in attns:
        a.audit, a.logit_max = True, None
    try:
        set_kernel_mode(model, "", softmax)
        model.eval()
        with torch.no_grad():
            model(x)
        return float(torch.stack([a.logit_max for a in attns]).max())
    finally:
        for a in attns:
            a.audit, a.logit_max = False, None
        set_kernel_mode(model, mode, softmax)
        model.train(was_training)
