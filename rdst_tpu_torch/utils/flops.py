"""Parameter and FLOP counting (counterpart of ``rdst_tpu/utils/flops.py``,
which reads XLA's cost analysis of the compiled forward).

``count_flops`` runs the call under ``torch.utils.flop_counter.
FlopCounterMode``: it counts the matrix products and convolutions (two
operations a multiply-add) and nothing elementwise. The port's kernels
are opaque to it, so the CLI counts the plain route (``pallas_kernels``
off) on the CPU: the kernels compute the same function. The counter
gives no byte figure, and the CLI prints ``null`` for the JAX CLI's
``forward_bytes`` / ``grad_bytes``, never a guess.

    python -m rdst_tpu_torch.utils.flops --config-file X.ini
        [--lr-hw H W] [--batch N] [--scale S] [--grad]
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def count_params(model: torch.nn.Module) -> int:
    """The number of trained parameter entries: the flax ``params``
    tree's (the frozen MeanShift convolutions are constants there)."""
    return int(sum(p.numel() for p in model.parameters()
                   if p.requires_grad))


def count_flops(fn: Callable, *args) -> Tuple[float, dict]:
    """(total FLOPs, FLOPs by operator) of ``fn(*args)``, counted by
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    return float(counter.get_total_flops()), by_op


def model_summary(model: torch.nn.Module, x: torch.Tensor,
                  scale=None) -> str:
    """One line: the model's name, parameters and forward GFLOPs at
    ``x``'s shape."""
    with torch.no_grad():
        flops, _ = count_flops(model, x, scale)
    return (f"{type(model).__name__}: {count_params(model) / 1e6:.3f}M "
            f"params, {flops / 1e9:.2f} GFLOPs @ {tuple(x.shape)}")


def plain_model(paras) -> torch.nn.Module:
    """The config's generator on the plain route (no kernel), float32, on
    the CPU, in eval mode."""
    from rdst_tpu_torch.models import build_generator
    from rdst_tpu_torch.models.routes import set_kernel_mode

    model = build_generator(paras)
    set_kernel_mode(model, "")
    return model.eval()


def main(argv=None):
    """The counting CLI: one JSON line with the JAX CLI's keys (``model``,
    ``params``, ``lr_shape``, ``scale``, ``forward_flops``,
    ``forward_bytes``; with ``--grad`` also ``grad_flops``,
    ``grad_bytes``: the forward and backward of an L1 loss over it, the
    training proxy)."""
    import argparse
    import json

    from rdst_tpu_torch.config import ParametersLoader

    ap = argparse.ArgumentParser(description="FLOP count of a config")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--lr-hw", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="LR input shape (default: config patch_size)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--scale", type=float, default=4.0)
    ap.add_argument("--grad", action="store_true",
                    help="also count the L1 loss's forward and backward")
    args = ap.parse_args(argv)

    paras = ParametersLoader(args.config_file)
    hw = tuple(args.lr_hw or (paras.patch_size, paras.patch_size))
    b = int(args.batch or paras.batch_size)
    c = int(paras.input_channel)
    model = plain_model(paras)
    x = torch.zeros((b, hw[0], hw[1], c))
    out = {"model": str(paras.get("feature_generator")),
           "params": count_params(model), "lr_shape": [b, *hw, c],
           "scale": args.scale}
    with torch.no_grad():
        out["forward_flops"], _ = count_flops(model, x, args.scale)
    out["forward_bytes"] = None
    if args.grad:
        def loss():
            torch.mean(torch.abs(model(x, args.scale))).backward()

        out["grad_flops"], _ = count_flops(loss)
        out["grad_bytes"] = None
    print(json.dumps(out))


if __name__ == "__main__":
    main()
