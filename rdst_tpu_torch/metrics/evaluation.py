"""Evaluation harness: metric registries and per-scale SR reports.

The port's own copy of ``rdst_tpu/metrics/evaluation.py`` (numpy and the standard
library only), kept so that the port imports nothing of ``rdst_tpu``.

Re-designs the reference evaluation stack
(upstream metrics/sr_metrics.py:16-135,
upstream metrics/sr_evaluation.py:116-296) for the TPU pipeline:
metric math runs host-side on numpy (off the hot path), while images
arrive as NHWC numpy arrays straight from device buffers. Report keys,
margin-crop rule (int(ceil(scale)) pixels), plain-text summaries, training
curves, and .npy dumps keep the reference formats so downstream tooling
works unchanged.
"""

from __future__ import annotations

import warnings
from os.path import join
from typing import Dict, List, Sequence

import numpy as np
from rdst_tpu_torch.metrics.image_metrics import METRIC_FUNCS


def tabulate(rows, headers) -> str:
    """A plain-text table in the layout of ``tabulate``'s default
    format: columns padded to their widest cell, a dashed rule under the
    headers."""
    cells = [[str(h) for h in headers]] + [[str(v) for v in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]

    def line(r):
        return "  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip()

    rule = "  ".join("-" * w for w in widths)
    return "\n".join([line(cells[0]), rule] + [line(r) for r in cells[1:]])


def _to_hwc_list(imgs, margin: int) -> List[np.ndarray]:
    """Accept HWC / NHWC arrays, lists of them, or device arrays."""
    if isinstance(imgs, (list, tuple)):
        imgs = np.stack([np.asarray(i) for i in imgs])
    imgs = np.asarray(imgs)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if imgs.ndim != 4:
        raise ValueError("images must be HWC or NHWC")
    h, w = imgs.shape[1:3]
    imgs = imgs[:, margin : h - margin, margin : w - margin, :]
    return list(imgs)


class SRMetrics:
    """Metric registry built from a space-separated string.

    ``return_mode='full'`` keeps per-image score lists; ``'mean'``
    reduces each metric to a scalar. FID is batch-level (single score).
    """

    def __init__(self, metrics: str = "", gpu_id: int = -1, return_mode: str = "full",
                 fid_paras=(3, 16)):
        if return_mode not in ("full", "mean"):
            raise ValueError("return mode must be one of [mean, full]")
        self.metrics = metrics.split()
        self.return_mode = return_mode
        self.functions = {}
        self.fid_functions = {}
        for m in self.metrics:
            if m in METRIC_FUNCS:
                self.functions[m] = METRIC_FUNCS[m]
            elif m == "fid":
                from rdst_tpu_torch.metrics.fid import FID

                self.fid_functions[m] = FID(gpu_id, *fid_paras)
            else:
                raise ValueError(f"Do not support this metric: {m}")

    def __call__(self, gts, preds, margin: int = 0) -> Dict[str, object]:
        gts = _to_hwc_list(gts, margin)
        preds = _to_hwc_list(preds, margin)
        reports: Dict[str, object] = {}
        for m, func in self.functions.items():
            reports[m] = [func(g, p) for g, p in zip(gts, preds)]
        for m, func in self.fid_functions.items():
            try:
                reports[m] = [func(gts, preds)]
            except Exception as e:  # a broken aggregate metric must not
                # void the whole (possibly hours-long) run's report
                warnings.warn(f"metric {m!r} failed ({e}); recording nan")
                reports[m] = [float("nan")]
        if self.return_mode == "mean":
            for m in reports:
                reports[m] = float(np.mean(reports[m]))
        return reports


class MetaSREvaluation:
    """Per-scale evaluation over multi-scale test samples.

    ``__call__(rec_imgs, samples)``: samples are per-pair dicts keyed by
    scale with ``{'gt': HWC array, ...}``; rec_imgs the same keyed by
    scale. Report keys are ``'{metric}_{scale}'``.
    """

    def __init__(self, metrics: str, sr_factors: Sequence[float], gpu_id: int = -1,
                 record_mode: str = "full"):
        assert record_mode in ("full", "mean")
        self.sr_factors = list(sr_factors)
        self.record_mode = record_mode
        self.func = SRMetrics(metrics, gpu_id, record_mode)
        self.basic_metrics = self.func.metrics
        self.metrics = [f"{m}_{s}" for m in self.basic_metrics for s in self.sr_factors]

    def get_metrics(self):
        return self.metrics

    def __call__(self, rec_imgs, samples):
        if isinstance(samples, dict):
            samples, rec_imgs = [samples], [rec_imgs]
        assert len(rec_imgs) == len(samples)
        report = {}
        for s in self.sr_factors:
            gts = [sample[s]["gt"] for sample in samples]
            recs = [rec[s] for rec in rec_imgs]
            scale_report = self.func(gts, recs, int(np.ceil(s)))
            for m, v in scale_report.items():
                report[f"{m}_{s}"] = v
        return report

    def display_images(self, rec_imgs, samples):
        if isinstance(samples, dict):
            samples, rec_imgs = [samples], [rec_imgs]
        all_imgs = {}
        for s in self.sr_factors:
            imgs = []
            for rec, sample in zip(rec_imgs, samples):
                imgs.append(rec[s])
                imgs.append(sample[s]["gt"])
            all_imgs[f"SR x{s}"] = imgs
        return all_imgs

    def print(self, report) -> str:
        table = []
        for s in self.sr_factors:
            row = ["{:.2}".format(float(s))]
            for m in self.basic_metrics:
                v = report[f"{m}_{s}"]
                if isinstance(v, (float, int)):
                    row.append("{:.4}".format(v))
                else:
                    if isinstance(v, list) and v and isinstance(v[0], list):
                        v = np.concatenate(v)
                    row.append("{:.4}({:.2})".format(float(np.mean(v)), float(np.std(v))))
            table.append(row)
        return tabulate(table, headers=["SR"] + self.basic_metrics)

    def plot_process(self, reports, plot_dir, prefix="", step=1) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plog = ""
        for m in self.basic_metrics:
            data = {}
            for s in self.sr_factors:
                k = f"{m}_{s}"
                vs = []
                for r in reports:
                    v = r[k]
                    vs.append(v if isinstance(v, (float, int)) else float(np.mean(v)))
                data["sr: {:.2}".format(float(s))] = vs
            for k in sorted(data):
                plt.plot(data[k])
            plt.legend(sorted(data))
            plt.xlabel("Training Step")
            plt.ylabel(m)
            plt.grid(True)
            plt.xticks(np.arange(len(reports)) * step)
            plt.savefig(join(plot_dir, f"{prefix}_{m}.png"))
            plt.close()
            plog += f"Figure saved: {prefix}_{m}.png\n"
        return plog

    def plot_final_evas(self, report, plot_dir, prefix):
        pass

    def save(self, reports, folder, prefix) -> str:
        path = join(folder, f"{prefix}.npy")
        np.save(path, np.asarray(reports, dtype=object))
        return f"All reports saved to {path}"

    def stack_eva_reports(self, reports) -> Dict[str, list]:
        """Concatenate per-case 'full' reports into one report."""
        stacked: Dict[str, list] = {}
        for r in reports:
            for k, v in r.items():
                stacked.setdefault(k, []).extend(v if isinstance(v, list) else [v])
        return stacked


class MultiModalityMetaSREvaluation(MetaSREvaluation):
    """Per-modality reports (BraTS): channel-sliced nested evaluation."""

    def __init__(self, modalities, metrics, sr_factors, gpu_id=-1, record_mode="full"):
        self.modalities = list(modalities)
        super().__init__(metrics, sr_factors, gpu_id, record_mode)

    def __call__(self, rec_imgs, samples):
        if isinstance(samples, dict):
            samples, rec_imgs = [samples], [rec_imgs]
        all_reports = {}
        for i, modality in enumerate(self.modalities):
            report = {}
            for s in self.sr_factors:
                gts = [sample[s]["gt"][:, :, i : i + 1] for sample in samples]
                recs = [rec[s][:, :, i : i + 1] for rec in rec_imgs]
                scale_report = self.func(gts, recs, int(np.ceil(s)))
                for m, v in scale_report.items():
                    report[f"{m}_{s}"] = v
            all_reports[modality] = report
        return all_reports

    def print(self, report) -> str:
        return "".join(
            f"\n{m} performance:\n" + super(MultiModalityMetaSREvaluation, self).print(report[m])
            for m in report
        )

    def plot_process(self, reports, plot_dir, prefix="", step=1) -> str:
        plog = ""
        for m in self.modalities:
            plog += f"\nPlotting {m}\n"
            plog += super().plot_process([r[m] for r in reports], plot_dir, f"{prefix}{m}", step)
        return plog

    def save(self, reports, folder, prefix) -> str:
        plog = ""
        for m in self.modalities:
            plog += f"\n{m}\n" + super().save([r[m] for r in reports], folder, f"{prefix}{m}")
        return plog

    def stack_eva_reports(self, reports):
        return {
            m: super(MultiModalityMetaSREvaluation, self).stack_eva_reports([r[m] for r in reports])
            for m in self.modalities
        }


class SegmentationEvaluation:
    """Per-class Dice over label volumes (reference seg_evaluation.py:11-63)."""

    def __init__(self, n_classes: int = 4):
        self.n_classes = n_classes

    def __call__(self, pred_labels, gt_labels):
        from rdst_tpu_torch.metrics.image_metrics import dice_coefficient

        return dice_coefficient(gt_labels, pred_labels, self.n_classes)
