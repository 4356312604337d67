"""Record a training run step by step on each rank, so that N ranks can be
held against one: ``python -m rdst_tpu_torch.train``'s own run (setup,
sampler, steps, evaluations, snapshots), with every ``train_step``
recorded. The tests and ``chip_smoke.py`` start it on each rank of a data
axis with :func:`rdst_tpu_torch.parallel.launch.spawn`, and once outside a
group for the one-rank run:

    spawn(record_runs, devices, [(argv, out_dir), ...], devices)
    record_runs([(argv, out_dir), ...])

Each run writes ``{out_dir}/rank{r}.npz``: per step the total loss, the
guard, the report, the generator's flat parameters and Adam first moment
after the step (the gradient is ``(mu_t - b1 mu_{t-1}) / (1 - b1)``) and,
with a discriminator, its flat parameters and buffers, and the rows of
the batch this rank ran the generator on; the parameters' sizes (to cut
the flat buffers back into tensors); the kernel launch counts of the
run, its steps/s of host time (``SRTrainer.steps_per_s``, with the
recording's reads of the card each step); and the rank and the group's
size.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in tensors]).numpy()


def _launches() -> dict:
    from rdst_tpu_torch.kernels import block_train, pair_train

    return {"pair_forward": pair_train.launch_forward.launches,
            "pair_backward": pair_train.launch_backward.launches,
            "block_forward": block_train.launch_forward.launches,
            "block_backward": block_train.launch_backward.launches}


def record_run(argv, out_dir: str, devices=None) -> None:
    """Build the trainer as ``python -m rdst_tpu_torch.train argv`` does
    (this process's rank of the group it is in), train it with each step
    recorded, and write ``{out_dir}/rank{r}.npz``."""
    from rdst_tpu_torch.cli import build_trainer

    trainer = build_trainer(argv, devices)
    rec = {"loss": [], "ok": [], "params": [], "mu": [], "d_state": [],
           "report": [], "rows": []}
    step = trainer.train_step

    def recorded(batch, ts):
        n = len(batch["in"])
        rec["rows"].append(n // trainer.mesh.world
                           if trainer.mesh.holds_rows(n) else n)
        total, report, ok = step(batch, ts)
        rec["loss"].append(float(total))
        rec["ok"].append(bool(ok))
        rec["report"].append({k: float(v) for k, v in report.items()})
        rec["params"].append(_flat(trainer.params))
        if "mu" in trainer.opt.state:
            rec["mu"].append(trainer.opt.state["mu"].cpu().numpy().copy())
        adv = trainer.loss.adversarial
        if adv is not None:
            rec["d_state"].append(_flat(adv.discriminator.state_dict()
                                        .values()))
        return total, report, ok

    trainer.train_step = recorded
    before = _launches()
    trainer.setup()
    trainer.train()
    launches = {k: v - before[k] for k, v in _launches().items()}
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"rank{trainer.mesh.rank}.npz"),
             loss=np.asarray(rec["loss"]), ok=np.asarray(rec["ok"]),
             params=np.stack(rec["params"]),
             mu=np.stack(rec["mu"]) if rec["mu"] else np.zeros(0),
             d_state=(np.stack(rec["d_state"]) if rec["d_state"]
                      else np.zeros(0)),
             report=np.asarray(rec["report"], dtype=object),
             rows=np.asarray(rec["rows"]),
             numels=np.asarray([p.numel() for p in trainer.params]),
             steps_per_s=trainer.steps_per_s,
             launches=np.asarray(launches, dtype=object),
             rank=trainer.mesh.rank, world=trainer.mesh.world,
             output_root=trainer.output_root)


def record_runs(runs, devices=None) -> None:
    """:func:`record_run` for each ``(argv, out_dir)`` of ``runs``, in
    order, in one process (one group's ranks share their start-up)."""
    for argv, out_dir in runs:
        record_run(argv, out_dir, devices)


def load(out_dir: str, rank: int = 0) -> dict:
    """One rank's record of :func:`record_run` (a file this package
    wrote)."""
    with np.load(os.path.join(out_dir, f"rank{rank}.npz"),
                 allow_pickle=True) as f:
        d = {k: f[k] for k in f.files}
    d["report"] = list(d["report"])
    d["launches"] = d["launches"].item()
    return d
