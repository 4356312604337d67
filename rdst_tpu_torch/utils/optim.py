"""Optimizers and LR schedules (counterpart of ``rdst_tpu/utils/optim.py``,
which builds them with optax), on lists of PyTorch tensors.

* ``opt`` in {Adam, SGD, RMSprop} with ``learning_rate``,
  ``weight_decay``, ``beta1``/``beta2``, ``epsilon``, ``momentum``, in
  optax's arithmetic: a weight decay is added to the gradient first
  (``add_decayed_weights``), then the optimizer's transform, then the
  learning rate (``scale_by_learning_rate``, evaluated at the count of
  updates made so far), then, for RMSprop, the momentum trace;
* ``lr_decay_type`` 'step N' (x gamma every N updates) or 'milestones a b
  c' (x gamma at each milestone reached, ``piecewise_constant_schedule``),
  anything else a constant rate.

State (moments, count) is float32 on the parameters' device; updates are
written into the parameters in place, which bumps their version counters
so that the serving kernels' folded-weight plans refold. A guarded step
(``Optimizer.step(grads, ok)``) is decided on the device, so a training
step never waits for the card. Under data parallelism the optimizer's
owner hands it the reduction of the flat gradient over the ranks
(``reduce``): the guard is then decided on the reduced gradient, the same
on every rank.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch


def tree_finite(tensors) -> torch.Tensor:
    """A 0-d bool tensor: every tensor (None skipped) is finite, by their
    norms (one multi-tensor reduction, decided on the tensors' device
    without a host sync); a norm overflows only for entries near the
    float32 limit, which the loss guard refuses long before."""
    ts = [t for t in tensors if t is not None]
    if not ts:
        return torch.tensor(True)
    return torch.isfinite(torch.stack(torch._foreach_norm(ts))).all()


def make_schedule(paras) -> Callable:
    """Learning rate as a function of the number of updates made (an int,
    or a 0-d tensor, for which the rate is a tensor on its device)."""
    base_lr = float(paras.learning_rate)
    decay_type: Optional[str] = paras.get("lr_decay_type")
    gamma = float(paras.get("lr_decay_gamma", 0.5))
    parts = str(decay_type).split() if decay_type else []
    if len(parts) == 2 and parts[0] == "step":
        step = int(parts[1])
        return lambda count: base_lr * gamma ** (count // step)
    if len(parts) > 1 and parts[0] == "milestones":
        milestones = sorted(int(m) for m in parts[1:])
        return lambda count: base_lr * gamma ** sum(count >= m
                                                     for m in milestones)
    return lambda count: base_lr


class Optimizer:
    """One optimizer over ``params`` (float32 tensors), as
    ``make_optimizer`` builds it in the JAX package.

    The state is flat: one float32 buffer per moment over all parameters,
    and the count of updates applied as a 0-d tensor, so that a step is a
    few launches over one buffer and can be made conditional on the
    device (``step(grads, ok)``) without the host reading anything.

    ``reduce`` (optional): applied to the flat float32 gradient before the
    update, e.g. its sum over the ranks of a data axis; the step is then
    also refused where the reduced gradient is not finite."""

    def __init__(self, params: List[torch.Tensor], paras,
                 reduce: Optional[Callable[[torch.Tensor],
                                           torch.Tensor]] = None):
        self.params = list(params)
        self.reduce = reduce
        self.schedule = make_schedule(paras)
        self.name = paras.opt
        if self.name not in ("Adam", "SGD", "RMSprop"):
            raise ValueError(f"Optimizer {self.name} not supported "
                             "(Adam/SGD/RMSprop)")
        self.wd = float(paras.get("weight_decay", 0) or 0)
        self.b1, self.b2 = float(paras.beta1), float(paras.beta2)
        self.eps = float(paras.epsilon)
        self.momentum = float(paras.get("momentum", 0.0) or 0.0)
        self.rms_decay = 0.9  # optax.rmsprop's default
        self.numels = [p.numel() for p in self.params]
        dev = self.params[0].device
        self.count_t = torch.zeros((), dtype=torch.float32, device=dev)
        names = {"Adam": ("mu", "nu"), "SGD": ("trace",),
                 "RMSprop": ("nu", "trace")}[self.name]
        self.state = {k: torch.zeros(sum(self.numels), dtype=torch.float32,
                                     device=dev) for k in names}

    @property
    def count(self) -> int:
        """Updates applied so far (reads the device)."""
        return int(self.count_t)

    @staticmethod
    def _flat(tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1).float() for t in tensors])

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             ok: Optional[torch.Tensor] = None) -> None:
        """Apply one update from ``grads`` (one tensor per parameter).
        ``ok`` (default true) is a 0-d bool tensor on the parameters'
        device: the parameters, the state and the count change only where
        it is true. optax's arithmetic; the rate and the bias corrections
        are evaluated on the device at the count of updates applied."""
        lr = self.schedule(self.count_t)
        count = self.count_t + 1
        g = self._flat(grads)
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=g.device)
        if self.reduce is not None:
            g = self.reduce(g)
            ok = ok & torch.isfinite(g).all()
        if self.wd:
            g = torch.add(g, self._flat(self.params), alpha=self.wd)
        st = self.state
        if self.name == "Adam":
            new = {"mu": torch.add(st["mu"] * self.b1, g,
                                   alpha=1.0 - self.b1),
                   "nu": torch.addcmul(st["nu"] * self.b2, g, g,
                                       value=1.0 - self.b2)}
            den = torch.sqrt(new["nu"] / (1.0 - torch.pow(self.b2, count)))
            u = (new["mu"] / (1.0 - torch.pow(self.b1, count))) / (
                den + self.eps) * -lr
        elif self.name == "SGD":
            new = {"trace": torch.add(st["trace"] * self.momentum, g)}
            u = new["trace"] * -lr
        else:
            nu = torch.addcmul(st["nu"] * self.rms_decay, g, g,
                               value=1.0 - self.rms_decay)
            u = g / torch.sqrt(nu + self.eps) * -lr
            new = {"nu": nu, "trace": torch.add(
                st["trace"] * self.momentum, u)}
            u = new["trace"]
        for k, v in new.items():
            st[k].copy_(torch.where(ok, v, st[k]))
        self.count_t.add_(ok.to(torch.float32))
        u = torch.where(ok, u, 0.0)
        torch._foreach_add_(self.params, [
            v.view_as(p) for v, p in zip(u.split(self.numels), self.params)])

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count_t, "state": self.state}

    def load_state_dict(self, d: Dict[str, object]) -> None:
        self.count_t.copy_(torch.as_tensor(d["count"]))
        for k, v in d["state"].items():
            self.state[k].copy_(v)


class _Keys(dict):
    """A dict read as a config (``paras.key`` and ``paras.get``)."""

    __getattr__ = dict.__getitem__


def adam(params: List[torch.Tensor], lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """``optax.adam(lr)`` with its defaults (``eps_root`` 0) at a constant
    rate, as an :class:`Optimizer` over ``params``."""
    return Optimizer(params, _Keys(opt="Adam", learning_rate=lr, beta1=b1,
                                   beta2=b2, epsilon=eps))


class Timer:
    """tic/toc wall timer (the JAX package's ``Timer``)."""

    def __init__(self):
        self.t0 = time.time()

    def tic(self):
        self.t0 = time.time()

    def toc(self) -> float:
        return time.time() - self.t0
