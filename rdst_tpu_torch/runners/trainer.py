"""Training orchestration (counterpart of ``rdst_tpu/runners/trainer.py``),
in PyTorch on one device.

Same artifacts as the JAX trainer: the output tree
``{output_dir}/{model_name}_{gan_type}/`` with ``training_log.txt``,
``metrics.jsonl``, ``models/{state}_model_g.msgpack`` (flax-readable,
``checkpoint.msgpack_writer``) and its ``.stats.json`` sidecar (with the
audited ``attn_logit_max``), the best quick-eval snapshot, and
``checkpoint/`` for resume (``torch.save`` of the parameters, the
optimizer state and the generator state, plus ``host_state.json``); with
an adversarial term also ``models/{state}_loss_d.msgpack``, the
discriminator's ``params`` and ``batch_stats`` in the flax layout, and
the discriminator with its optimizer in the checkpoint.

One optimizer step per "epoch", as in the JAX package:

* the batch sampler runs in a thread, a few batches ahead;
* the forward in ``training_dtype`` (bf16: float32 master parameters,
  bf16 activations; each layer on the train-pair or single-block train
  kernels, as ``models.routes.set_train_mode`` decides, unless
  ``pallas_train='off'``), the loss in float32, the gradients by
  autograd;
* the guarded update: the step is skipped on a non-finite loss or
  gradient, or a loss >= ``loss_threshold``;
* in a training state with a GAN term, the JAX trainer's alternating
  step: a generator forward without gradient, ``gan_k`` discriminator
  updates on it (``losses.adversarial``), then the generator's forward,
  loss and update against the refreshed discriminator;
* the guard is decided on the device and loss scalars are fetched to the
  host in batches (``scalar_flush_steps``) and at every check, so the
  host does not wait for the card between checks;
* every ``check_every`` steps: the logit audit, a quick evaluation on the
  serving routes (eval mode, no gradient), a checkpoint.

``pallas_softmax='auto'`` starts from the audited bound of
``pre_trained_g`` (0 for a fresh init: clamp) and escalates to the stable
softmax once an audit reaches the margin. ``residual_scale > 0`` and
``scale_free`` training raise: MetaSR's training is not ported.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from os.path import exists, join
from typing import Dict, Optional

import numpy as np
import torch

from rdst_tpu_torch.losses.sr_loss import SRLoss
from rdst_tpu_torch.utils.optim import Optimizer, Timer, tree_finite


def fancy_print(msg: str) -> str:
    bar = "#" * max(32, len(msg) + 8)
    return f"\n{bar}\n#   {msg}\n{bar}\n"


def truncated_normal(t: torch.Tensor, generator: torch.Generator,
                     std: float) -> None:
    """Fill ``t`` with standard normal draws cut at 2, times ``std``."""
    v = torch.randn(t.shape, generator=generator, device=t.device)
    while True:
        bad = v.abs() > 2.0
        if not bad.any():
            break
        v[bad] = torch.randn(int(bad.sum()), generator=generator,
                             device=t.device)
    t.copy_(std * v)


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers: dense kernels and relative-position
    tables truncated normal (std 0.02, cut at 2 std), dense biases zero,
    LayerNorms one and zero, convolution kernels uniform within
    sqrt(1 / fan_in) (torch's default) and their biases zero. The frozen
    MeanShift convs are left as they are."""
    from rdst_tpu_torch.nn.layers import LayerNorm, Linear
    from rdst_tpu_torch.nn.swin import WindowAttention

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Linear):
                truncated_normal(m.weight, generator, 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                bound = fan_in ** -0.5
                u = torch.rand(m.weight.shape, generator=generator,
                               device=m.weight.device)
                m.weight.copy_((2 * u - 1) * bound)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                truncated_normal(m.relative_position_bias_table,
                                 generator, 0.02)


def pin_batch(batch: dict) -> dict:
    """The batch's arrays as page-locked tensors, so that a step's copy to
    the card does not wait for the work queued before it."""
    return {k: torch.from_numpy(v).pin_memory()
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


class SRTrainer:
    """Generator-only SR trainer on one device (``device``: 'cuda' unless
    the caller asks for 'cpu')."""

    def __init__(self, paras, ds_train, ds_valid, seed: int = 0,
                 device="cuda"):
        from rdst_tpu_torch.checkpoint.loading import read_stats_sidecar
        from rdst_tpu_torch.device import resolve_device
        from rdst_tpu_torch.kernels.swin_block import resolve_softmax_auto
        from rdst_tpu_torch.kernels.window_attention import (kernel_flags,
                                                             train_flag)
        from rdst_tpu_torch.models import build_generator
        from rdst_tpu_torch.models.routes import set_kernel_mode, set_train_mode
        from rdst_tpu_torch.nn.layers import set_generator

        self.paras = paras
        self.ds_train, self.ds_valid = ds_train, ds_valid
        self.verbose = paras.verbose
        self.device = resolve_device(device)
        gan_type = paras.get("gan_type", "None")
        self.residual_scale = float(paras.get("residual_scale", 0.0) or 0.0)
        if self.residual_scale > 0:
            raise NotImplementedError(
                "training with residual_scale > 0 (MetaSR's bicubic blend "
                "of the model embedding) is not ported")
        if paras.get("scale_free"):
            raise NotImplementedError(
                "scale_free training (MetaSR's arbitrary scales) is not "
                "ported")
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        mean = getattr(ds_train, "mean", [0.0])
        std = getattr(ds_train, "std", [1.0])
        tdt = str(paras.get("training_dtype", "") or "").lower()
        self.dtype = (torch.bfloat16 if tdt in ("bfloat16", "bf16")
                      else torch.float32)
        self.model = build_generator(paras, mean, std, dtype=self.dtype)
        self.model.to(self.device)
        set_train_mode(self.model, train_flag(paras))
        # pallas_softmax='auto' in training: from the warm start's stamp
        # (0 for a fresh init: clamp), escalated by the audits
        softmax = kernel_flags(paras).softmax
        self._softmax_auto = softmax == "auto"
        self._logit_bound: Optional[float] = None
        if self._softmax_auto:
            pre = paras.get("pre_trained_g")
            pre = pre if isinstance(pre, str) and pre not in ("", "None") \
                else None
            bound = ((read_stats_sidecar(pre) or {}).get("attn_logit_max")
                     if pre else 0.0)
            softmax = resolve_softmax_auto(bound)
        set_kernel_mode(self.model, self.model.kernel_mode, softmax,
                        self.model.quant)
        set_generator(self.model, self.generator)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.opt = Optimizer(self.params, paras)
        self.loss = SRLoss(paras).to(self.device)

        self.training_states = list(paras.training_states)
        self.epochs_in_total: Dict[str, int] = dict(paras.epochs_in_total)
        self.check_every = paras.check_every
        self.loss_threshold = paras.loss_threshold
        self.scalar_flush_steps = int(paras.get("scalar_flush_steps", 64)
                                      or 64)
        self._metrics_consumed: Dict[tuple, int] = {}
        self.quick_eva_func = ds_valid.get_quick_eva_func()
        self.final_eva_func = ds_valid.get_final_eva_func()
        self.quick_eva_num_samples = paras.quick_eva_num_samples

        self.step = 0
        self.current_state_id = 0
        self.current_epoch = 0
        self.training_loss_records: Dict[str, list] = {}
        self.quick_validation_reports: list = []
        self.training_epoch_costs: list = []
        self._last_total_f = float("nan")
        self._best_quick: Dict[str, float] = {}
        self._probe_x = None

        self.output_root = join(paras.output_dir,
                                f"{paras.model_name}_{gan_type}")
        self.dirs = {name: join(self.output_root, name)
                     for name in ("models", "records", "plots",
                                  "final_results", "inferences")}
        self.checkpoint_dir = join(self.output_root, "checkpoint")
        self.log_file = join(self.output_root, "training_log.txt")
        self.metrics_file = join(self.output_root, "metrics.jsonl")

    # -- setup / checkpointing ----------------------------------------------

    def setup(self):
        os.makedirs(self.output_root, exist_ok=True)
        for d in list(self.dirs.values()) + [self.checkpoint_dir]:
            os.makedirs(d, exist_ok=True)
        self.write_log(str(self.paras))
        init_weights(self.model, self.generator)
        tl_log = self.weights_init()
        if self.loss.adversarial is not None:
            self.loss.adversarial.init(
                self.device, torch.Generator().manual_seed(self.seed + 1))
            tl_log += self._weights_init_d()
        self.write_log(tl_log.rstrip("\n"))
        if exists(join(self.checkpoint_dir, "host_state.json")):
            self.load_checkpoint()
            self.write_log(fancy_print(
                f"Resumed from checkpoint: state_id={self.current_state_id} "
                f"epoch={self.current_epoch}"))
        else:
            self.write_log(fancy_print("Model initialized from scratch"))
        self.write_log(f"device {self.device}, dtype {self.dtype}, train "
                       f"route {self.model.train_mode or 'plain'} "
                       f"{self.model.train_routes}, eval routes "
                       f"{self.model.routes}, softmax {self.model.softmax}, "
                       f"int8 {sorted(self.model.quant)}")

    def weights_init(self) -> str:
        """Warm start from ``pre_trained_g`` (a flax ``.msgpack``
        snapshot; no optimizer state), else keep the fresh init."""
        from rdst_tpu_torch.checkpoint.loading import load_well_trained_params

        g_path = self.paras.get("pre_trained_g")
        if isinstance(g_path, str) and g_path not in ("", "None"):
            if not exists(g_path):
                raise FileNotFoundError(
                    f"pre_trained_g points at a missing file: {g_path}")
            load_well_trained_params(self.model, self.paras, g_path, [])
            return f"Init G with pre-trained model: {g_path}\n"
        return "Initialize G by default (seeded init)\n"

    def _weights_init_d(self) -> str:
        """Weights-only warm start of the discriminator from a
        ``{state}_loss_d.msgpack`` snapshot named by ``pre_trained_d``
        (its ``params`` and ``batch_stats``; the optimizer starts anew)."""
        from rdst_tpu_torch.checkpoint.convert import export_discriminator
        from rdst_tpu_torch.checkpoint.msgpack_reader import read_snapshot

        d_path = self.paras.get("pre_trained_d")
        if not (isinstance(d_path, str) and d_path not in ("", "None")):
            return "Initialize D by default (seeded init)\n"
        if not exists(d_path):
            raise FileNotFoundError(
                f"pre_trained_d points at a missing file: {d_path}")
        if d_path.endswith((".pt", ".pth")):
            raise ValueError(
                "pre_trained_d torch import is not mapped -- export the "
                "discriminator to msgpack (models/{state}_loss_d.msgpack) "
                "and point pre_trained_d at that instead")
        adv = self.loss.adversarial
        raw = read_snapshot(d_path)
        sd = export_discriminator({"params": raw["params"],
                                   "batch_stats": raw.get("batch_stats", {})},
                                  adv.map_chw)
        adv.discriminator.load_state_dict(
            {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in sd.items()})
        adv.reset_optimizer()
        return f"Init Adversarial Loss with pre-trained model: {d_path}\n"

    def save_checkpoint(self):
        state = {"model": self.model.state_dict(),
                 "optimizer": self.opt.state_dict(),
                 "generator": self.generator.get_state()}
        if self.loss.adversarial is not None:
            state["adversarial"] = self.loss.adversarial.state_dict()
        torch.save(state, join(self.checkpoint_dir, "state.pt"))
        host = {
            "current_state_id": self.current_state_id,
            "current_epoch": self.current_epoch,
            "step": self.step,
            "training_loss_records": self.training_loss_records,
            "training_epoch_costs": self.training_epoch_costs,
            "loss_records": self.loss.state_dict(),
            "best_quick": self._best_quick,
            "logit_bound": self._logit_bound,
            "softmax": self.model.softmax,
        }
        with open(join(self.checkpoint_dir, "host_state.json"), "w") as f:
            json.dump(host, f)
        np.save(join(self.dirs["records"], "quick_validation_reports.npy"),
                np.asarray(self.quick_validation_reports, dtype=object))

    def load_checkpoint(self):
        state = torch.load(join(self.checkpoint_dir, "state.pt"),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())
        if self.loss.adversarial is not None:
            self.loss.adversarial.load_state_dict(state["adversarial"])
        with open(join(self.checkpoint_dir, "host_state.json")) as f:
            host = json.load(f)
        self.current_state_id = host["current_state_id"]
        self.current_epoch = host["current_epoch"]
        self.step = host["step"]
        self.training_loss_records = host["training_loss_records"]
        self.training_epoch_costs = host["training_epoch_costs"]
        self.loss.load_state_dict(host["loss_records"])
        self._best_quick = dict(host.get("best_quick", {}))
        if host.get("logit_bound") is not None:
            self._logit_bound = float(host["logit_bound"])
            self._maybe_escalate_softmax()
        reports = join(self.dirs["records"], "quick_validation_reports.npy")
        if exists(reports):
            self.quick_validation_reports = list(
                np.load(reports, allow_pickle=True))

    def _write_stats_sidecar(self, snapshot_path: str) -> None:
        """Normalization stats and the audited ``attn_logit_max`` beside
        the snapshot, as the JAX trainer writes them."""
        mean = getattr(self.ds_train, "mean", None)
        std = getattr(self.ds_train, "std", None)
        stats = {}
        if mean is not None or std is not None:
            stats["mean"] = np.asarray(mean, np.float64).tolist()
            stats["std"] = np.asarray(std, np.float64).tolist()
        if self._logit_bound is not None:
            stats["attn_logit_max"] = round(float(self._logit_bound), 3)
        if not stats:
            return
        with open(os.path.splitext(snapshot_path)[0] + ".stats.json",
                  "w") as f:
            json.dump(stats, f)

    def _write_snapshot(self, path: str) -> None:
        from rdst_tpu_torch.checkpoint.msgpack_writer import write_snapshot

        write_snapshot(path, self.model.state_dict())
        self._write_stats_sidecar(path)

    def save_models(self, training_state: str):
        path = join(self.dirs["models"], f"{training_state}_model_g.msgpack")
        self._write_snapshot(path)
        self.write_log(f"Saved model snapshot: {path}")
        adv = self.loss.adversarial
        if adv is not None:
            from rdst_tpu_torch.checkpoint.convert import import_discriminator
            from rdst_tpu_torch.checkpoint.msgpack_writer import to_bytes

            dpath = join(self.dirs["models"],
                         f"{training_state}_loss_d.msgpack")
            with open(dpath, "wb") as f:
                f.write(to_bytes(import_discriminator(
                    adv.discriminator.state_dict(), adv.map_chw)))
            self.write_log(f"Saved discriminator snapshot: {dpath}")

    # -- the step -------------------------------------------------------------

    def gan_active(self, training_state: str) -> bool:
        """The state has a GAN term: its step is the alternating one."""
        return self.loss.adversarial is not None and any(
            "GAN" in n for n in self.loss.loss_scalars[training_state])

    def device_batch(self, batch) -> dict:
        """The loss's batch on the device: ``out``, the dataset's labels
        ``seg_gt`` when it has them, and with an adversary the (B, 1)
        ``sr_scales`` column of the batch's scale (ScaleGAN's labels)."""
        dev = self.device
        out = {"out": torch.as_tensor(batch["out"]).to(dev, non_blocking=True)}
        if "seg_gt" in batch:
            out["seg_gt"] = torch.as_tensor(batch["seg_gt"]).to(
                dev, non_blocking=True)
        if self.loss.adversarial is not None:
            out["sr_scales"] = torch.full((out["out"].shape[0], 1),
                                          float(batch["sr_factor"]),
                                          device=dev)
        return out

    def train_step(self, batch, training_state: str):
        """One guarded optimizer step on a host batch; returns the total
        loss, the report and whether the update was applied, all as
        tensors on the device. The guard is decided there, as the JAX
        step decides it in the graph, so the host queues the next step
        while the card runs this one. In a GAN state the discriminator
        is updated first, on a generator forward without gradient."""
        x = torch.as_tensor(batch["in"]).to(self.device, non_blocking=True)
        dbatch = self.device_batch(batch)
        self.model.train()
        d_report = {}
        if self.gan_active(training_state):
            with torch.no_grad():
                fake = self.model(x).float()
            d_report = self.loss.adversarial.d_step(
                fake, dbatch["out"], dbatch["sr_scales"], self.generator)
        pred = self.model(x).float()  # the loss in f32 whatever the dtype
        total, report = self.loss(pred, dbatch, training_state)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        total = total.detach()
        ok = (torch.isfinite(total) & (total < float(self.loss_threshold))
              & tree_finite(grads))
        self.opt.step(grads, ok)
        report = {k: v.detach() for k, v in report.items()}
        report.update(d_report)
        return total, report, ok

    def _sampler(self, n: int, out_q: "queue.Queue", seed: int,
                 stop: threading.Event):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(n):
                item = self.ds_train.sample(rng)
                if self.device.type == "cuda":
                    item = pin_batch(item)
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # noqa: BLE001 - re-raised in train()
            out_q.put(e)
            return
        out_q.put(None)

    # -- main loop ------------------------------------------------------------

    def train(self):
        steps_this_run = 0
        for sid in range(self.current_state_id, len(self.training_states)):
            ts = self.training_states[sid]
            self.current_state_id = sid
            self.loss.set_training_state(ts)
            left = self.epochs_in_total[ts] - self.current_epoch
            if left <= 0:
                if not exists(join(self.dirs["models"],
                                   f"{ts}_model_g.msgpack")):
                    self.save_models(ts)
                    self.write_log(self.final_eva(ts))
                self.current_epoch = 0
                continue
            self.write_log(fancy_print(
                f"Training state {ts}: {left} epochs to go "
                f"(losses: {self.loss.active_terms(ts)})"))
            q: "queue.Queue" = queue.Queue(maxsize=4)
            stop = threading.Event()
            t = threading.Thread(target=self._sampler,
                                 args=(left, q, self.step + 17, stop),
                                 daemon=True)
            t.start()
            timer = Timer()
            pending: list = []
            try:
                while True:
                    batch = q.get()
                    if batch is None:
                        break
                    if isinstance(batch, BaseException):
                        raise batch
                    timer.tic()
                    total, report, _ = self.train_step(batch, ts)
                    self.step += 1
                    self.current_epoch += 1
                    steps_this_run += 1
                    pending.append((total, report))
                    at_check = self.current_epoch % self.check_every == 0
                    if len(pending) >= self.scalar_flush_steps or at_check:
                        self._flush_scalar_records(pending, ts)
                    self.training_epoch_costs.append(timer.toc())
                    if at_check:
                        plog = self.quick_eva()
                        self.save_checkpoint()
                        self.write_log(
                            f"[{ts}] epoch {self.current_epoch}/"
                            f"{self.epochs_in_total[ts]} "
                            f"loss={self._last_total_f:.6f} ("
                            f"{np.mean(self.training_epoch_costs[-self.check_every:]):.3f}"
                            f"s/epoch)\n" + plog)
                        self.log_metrics(ts)
            finally:
                stop.set()
                t.join(timeout=60)
            self._flush_scalar_records(pending, ts)
            self.save_models(ts)
            self.write_log(self.final_eva(ts))
            self.current_epoch = 0
        self.training_complete(steps_this_run)

    def _flush_scalar_records(self, pending, ts):
        """Fetch the deferred loss scalars in one transfer; diverged or
        filtered steps stay out of the records."""
        if not pending:
            return
        vals = torch.stack([torch.stack([tot] + list(rep.values()))
                            for tot, rep in pending]).float().cpu().numpy()
        names = list(pending[0][1].keys())
        pending.clear()
        for row in vals:
            total_f = float(row[0])
            self._last_total_f = total_f
            if np.isfinite(total_f) and total_f < self.loss_threshold:
                self.loss.record(dict(zip(names, map(float, row[1:]))), ts)
                self.training_loss_records.setdefault(ts, []).append(total_f)

    # -- evaluation -----------------------------------------------------------

    def _predict(self, lr: np.ndarray) -> np.ndarray:
        self.model.eval()
        with torch.no_grad():
            out = self.model(torch.from_numpy(lr).to(self.device))
        return out.float().cpu().numpy()

    def _infer_pairs(self, ids):
        """Batched whole-slice inference on the serving routes."""
        pairs = [self.ds_valid.get_test_pair(i) for i in ids]
        recs = [dict() for _ in ids]
        for s in sorted(pairs[0].keys()):
            lr = np.concatenate([p[s]["in"] for p in pairs], axis=0)
            out = self._predict(lr)
            for i in range(len(ids)):
                recs[i][s] = out[i]
        return recs, pairs

    def _probe_logit_bound(self) -> Optional[float]:
        """Audit the max attention logit on held validation slices and
        keep the running max (stamped into the sidecar)."""
        from rdst_tpu_torch.kernels.logit_audit import measure_logit_bound

        if self._probe_x is None:
            pair = self.ds_valid.get_test_pair(0)
            _, d = sorted(pair.items())[-1]
            self._probe_x = torch.from_numpy(d["in"][:4]).to(self.device)
        b = measure_logit_bound(self.model, self._probe_x)
        if b is not None and (self._logit_bound is None
                              or b > self._logit_bound):
            self._logit_bound = float(b)
        return b

    def _maybe_escalate_softmax(self) -> bool:
        """'auto': once the audited bound reaches the margin, the clamp
        variant gives way to the stable softmax, for training and eval."""
        from rdst_tpu_torch.kernels.swin_block import AUTO_CLAMP_MARGIN
        from rdst_tpu_torch.models.routes import set_kernel_mode

        if not (self._softmax_auto and self.model.softmax == "clamp"):
            return False
        if self._logit_bound is None or self._logit_bound < AUTO_CLAMP_MARGIN:
            return False
        set_kernel_mode(self.model, self.model.kernel_mode, "stable",
                        self.model.quant)
        self.write_log(
            f"pallas_softmax=auto: audited logit bound "
            f"{self._logit_bound:.1f} >= margin {AUTO_CLAMP_MARGIN:.0f} -- "
            "escalated to the stable softmax")
        return True

    def quick_eva(self) -> str:
        self._probe_logit_bound()
        self._maybe_escalate_softmax()
        n = min(self.quick_eva_num_samples, self.ds_valid.test_len())
        ids = self.rng.permutation(self.ds_valid.test_len())[:n]
        t0 = time.time()
        recs, pairs = self._infer_pairs(list(ids))
        report = self.quick_eva_func(recs, pairs)
        self.quick_validation_reports.append(report)
        plog = self.quick_eva_func.print(report)
        plog += self._keep_best_snapshot(report)
        plog += (f"\nQuick evaluation of {n} samples cost "
                 f"{time.time() - t0:.2f}s")
        return plog

    def _keep_best_snapshot(self, report) -> str:
        vals = [float(np.mean(v)) for k, v in report.items()
                if k.startswith("psnr") and np.size(v)]
        if not vals:
            return ""
        score = float(np.mean(vals))
        ts = self.training_states[self.current_state_id]
        if not np.isfinite(score) or \
                score <= self._best_quick.get(ts, float("-inf")):
            return ""
        self._best_quick[ts] = score
        path = join(self.dirs["models"], f"{ts}_model_g_best.msgpack")
        self._write_snapshot(path)
        return (f"\nNew best quick-eva PSNR {score:.2f} dB -> snapshot kept "
                f"at {path}")

    def final_eva(self, training_state: str) -> str:
        recs, pairs = self._infer_pairs(list(range(self.ds_valid.test_len())))
        report = self.final_eva_func(recs, pairs)
        plog = fancy_print(f"Final evaluation after {training_state}")
        plog += self.final_eva_func.print(report)
        self.final_eva_func.save([report], self.dirs["final_results"],
                                 f"{training_state}_final_eva")
        return plog

    def training_complete(self, steps_this_run: Optional[int] = None):
        summary = {"training_loss_records": self.training_loss_records,
                   "training_epoch_costs": self.training_epoch_costs}
        np.save(join(self.dirs["final_results"], "training_records.npy"),
                np.asarray(summary, dtype=object))
        if steps_this_run == 0:
            self.write_log(fancy_print(
                "Training already complete (resumed checkpoint, 0 new "
                "epochs)"))
        elif self.training_epoch_costs:
            self.write_log(fancy_print(
                f"Training complete: {len(self.training_epoch_costs)} "
                f"epochs, {np.mean(self.training_epoch_costs):.3f}s/epoch"))

    # -- logging --------------------------------------------------------------

    def write_log(self, plog: str):
        with open(self.log_file, "a") as f:
            f.write(plog + "\n")
        if self.verbose:
            print(plog, flush=True)

    def log_metrics(self, ts: str):
        """One structured record per check interval in metrics.jsonl."""
        rec = {"time": time.time(), "state": ts, "step": int(self.step),
               "epoch": int(self.current_epoch),
               "loss": float(self._last_total_f),
               "s_per_epoch": float(np.mean(
                   self.training_epoch_costs[-self.check_every:]))}
        for name, vals in self.loss.records.get(ts, {}).items():
            pos = self._metrics_consumed.get((ts, name), 0)
            if len(vals) > pos:
                rec[f"loss_{name.replace(' ', '_')}"] = float(
                    np.mean(vals[pos:]))
                self._metrics_consumed[(ts, name)] = len(vals)
        if self.quick_validation_reports:
            for k, v in self.quick_validation_reports[-1].items():
                try:
                    rec[f"eva_{k}"] = float(np.mean(v))
                except (TypeError, ValueError):
                    pass
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(rec) + "\n")


# the JAX package's name for the main trainer
TransSRTrainer = SRTrainer
