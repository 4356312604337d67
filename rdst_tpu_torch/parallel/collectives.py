"""The few collectives the data axis needs, on ``all_reduce`` and
``broadcast`` only: gloo runs only these on CUDA tensors, and NCCL refuses
two ranks on one device, so these two are what every group of the port
supports (two gloo ranks on one card included).

* :func:`gather_rows`: the batch's rows from every rank, differentiable:
  its forward places the local rows in their slot of a zero buffer and
  sums the buffers over the group (each slot has one non-zero term, so the
  sum is exact and the same on every rank); its backward returns the local
  slot of the incoming gradient with no collective, since every rank
  computes the same loss on the gathered rows.
* :func:`sum_over_ranks`: the flat gradient summed over the group;
  :func:`mean_over_ranks`: averaged, for a gradient every rank computed on
  the whole batch (the discriminator's), which keeps the ranks' copies
  equal where the card's kernels do not repeat themselves bit for bit.
* :func:`broadcast_module`: rank 0's parameters and buffers on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        n = x.shape[0]
        buf = x.new_zeros((n * world,) + tuple(x.shape[1:]))
        buf[rank * n:(rank + 1) * n] = x
        dist.all_reduce(buf)
        ctx.rows = (rank * n, (rank + 1) * n)
        return buf

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked in rank order along the
    leading dimension, on every rank; the gradient reaches each rank's own
    rows. Outside a process group ``x`` itself."""
    if not mesh.distributed:
        return x
    return _GatherRows.apply(x, mesh.rank, mesh.world)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group, in place; returns it."""
    dist.all_reduce(t)
    return t


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the group, in place; returns it."""
    dist.all_reduce(t)
    return t.div_(dist.get_world_size())


def max_over_ranks(value: float, device) -> float:
    """The largest ``value`` of any rank (a host number; reads the
    device)."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def per_rank(value: float, mesh) -> list:
    """Every rank's ``value``, in rank order (a host list; reads the
    device)."""
    t = torch.zeros(mesh.world, dtype=torch.float64, device=mesh.device)
    t[mesh.rank] = float(value)
    dist.all_reduce(t)
    return t.tolist()


def sync(device) -> None:
    """Return once every rank has reached this point (an ``all_reduce`` of
    one element, which every backend takes on every device)."""
    dist.all_reduce(torch.zeros(1, device=device))


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers copied into every rank's
    ``module``, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
