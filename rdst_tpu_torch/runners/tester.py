"""Testing / inference orchestration (counterpart of
``rdst_tpu/runners/tester.py``: ``SRTester``, ``TransSRTester``).

* a per-patient loop, each patient with a fresh test dataset;
* resume: a patient whose report is saved is not run again;
* all slices of a patient go through one forward per scale and come back
  as float32 numpy once: on one device, or over the config's data axis
  (``mesh_shape``, :mod:`rdst_tpu_torch.parallel`) with one replica of
  the model on each of its devices, the padded batch split into equal
  shards, as the JAX tester shards it (``shard_batch_padded``);
* ``feature_generator = 'bicubic'`` is a pass-through that scores the
  interpolated LR;
* ``tiled_inference = True`` runs overlapping LR patches through the
  model in chunks and folds them back (``data.folding.ImageFolder``);
* the model is called at each test scale: a scale-free model (MetaSR, a
  scale-free RDST) at the pair's real scale, any other at the nominal
  one;
* ``residual_scale > 0`` blends in the bicubic LR (MetaSR's eval blend);
* artifacts as the JAX tester writes them: the
  ``{model_name}_{gan_type}_Final_Predictions`` tree with
  ``inference_results/{pid}_inference_results.npz``,
  ``eva_reports/{pid}_eva_reports.npy``, ``images/``,
  ``stacked_eva_reports.npy`` and ``testing_log.txt``, so that a report
  cached by one package is read by the other.

The model, its weights, dtype, kernel routes, softmax variant and int8
groups come from ``serving.export.build_serving_model``.
"""

from __future__ import annotations

import os
import time
from os.path import exists, join
from typing import Dict, List

import numpy as np
import torch

from rdst_tpu_torch.data import ops
from rdst_tpu_torch.data.readers import make_test_dataset, testing_patient_ids
from rdst_tpu_torch.parallel.mesh import data_parallel, replicate_module
from rdst_tpu_torch.serving.export import build_serving_model, residual_blend


def _fancy(msg: str) -> str:
    bar = "#" * max(32, len(msg) + 8)
    return f"\n{bar}\n#   {msg}\n{bar}\n"


def tiled_sr(forward, lr: np.ndarray, hr_shape, paras, device,
             data: int = 1) -> np.ndarray:
    """``forward`` (NHWC LR patches -> SR patches, a tensor on ``device``)
    over ``lr`` cut into ``patch_size`` patches at
    ``test_lr_patch_stride``, in chunks of ``max(4 * batch_size, 8)``
    rounded up to a multiple of the data axis' ``data`` devices
    (``rdst_tpu/runners/tester.py:225-226``), folded back to ``hr_shape``
    (H, W, ...) with the overlaps averaged: ``tiled_inference = True``
    (basic_dataset.py:347-449)."""
    from rdst_tpu_torch.data.folding import ImageFolder

    n, h, w, c = lr.shape
    patch = int(paras.patch_size)
    stride = int(paras.get("test_lr_patch_stride", patch))
    lr_folder = ImageFolder((n, h, w, c), patch, stride)
    # the HR grid from the TRUE LR->HR ratio, not int(s)
    r = hr_shape[0] / h
    hr_folder = ImageFolder((n, hr_shape[0], hr_shape[1], c),
                            int(round(patch * r)), int(round(stride * r)))
    patches = lr_folder.unfold(torch.from_numpy(lr).to(device))
    chunk = -(-max(paras.batch_size * 4, 8) // data) * data
    sr = torch.cat([forward(patches[i:i + chunk])
                    for i in range(0, patches.shape[0], chunk)])
    return hr_folder.fold(sr).cpu().numpy()


class SRTester:
    """Scores ``testing_patient_ids`` by the ``test.py`` protocol on
    ``device`` ('cuda' unless the caller asks for 'cpu'): on the config's
    data axis there (every visible GPU by default), or on an explicit
    ``devices`` list."""

    def __init__(self, paras, device="cuda", devices=None):
        from rdst_tpu_torch.parallel import data_mesh_from_paras

        self.paras = paras
        self.verbose = paras.verbose
        self.mesh = data_mesh_from_paras(paras, device, devices)
        self.device = self.mesh.device
        self.replicas = []
        self.bicubic = paras.get("feature_generator") == "bicubic"
        self.model = self.manifest = None
        self.residual_scale = float(paras.get("residual_scale", 0.0) or 0.0)
        self.patient_ids = testing_patient_ids(paras)
        self.sr_scales = list(paras.get("sr_scales_for_final_testing",
                                        paras.test_sr_scales))
        # the test datasets build pairs from test_sr_scales; the tester
        # scores sr_scales_for_final_testing: align them
        paras.set("test_sr_scales", self.sr_scales)

        if "BraTS" in paras.data_folder:
            from rdst_tpu_torch.metrics.evaluation import \
                MultiModalityMetaSREvaluation

            self.eva_func = MultiModalityMetaSREvaluation(
                paras.modalities_brats, paras.eva_metrics_for_testing,
                self.sr_scales, paras.gpu_id, "full")
        else:
            from rdst_tpu_torch.metrics.evaluation import MetaSREvaluation

            self.eva_func = MetaSREvaluation(
                paras.eva_metrics_for_testing, self.sr_scales, paras.gpu_id,
                "full")
        gan_type = paras.get("gan_type", "None")
        self.output_root = join(
            paras.output_dir, f"{paras.model_name}_{gan_type}_Final_Predictions")
        self.dirs = {
            name: join(self.output_root, name)
            for name in ("inference_results", "eva_reports", "images")
        }
        self.log_file = join(self.output_root, "testing_log.txt")

    # -- setup ---------------------------------------------------------------

    def setup(self):
        """Make the output tree and build the model with its weights."""
        from rdst_tpu_torch.checkpoint.loading import resolve_model_path

        os.makedirs(self.output_root, exist_ok=True)
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)
        if self.bicubic:
            self.write_log(_fancy("Bicubic pass-through mode"))
            return
        self.model, self.manifest = build_serving_model(self.paras,
                                                        self.device)
        self.replicas = replicate_module(self.model, self.mesh.local_devices)
        self.write_log(_fancy("Loaded well-trained model: "
                              f"{resolve_model_path(self.paras)}"))

    # -- inference -------------------------------------------------------------

    def forward(self, x, sr_scale=None) -> torch.Tensor:
        """The model at ``sr_scale`` on an NHWC batch (numpy or a tensor),
        as f32 on the (first) device: each replica on its shard."""
        fns = [lambda s, m=m: m(s, sr_scale).float() for m in self.replicas]
        with torch.inference_mode():
            return data_parallel(self.mesh, fns, x)

    def model_scale(self, s: float, pairs) -> float:
        """The scale the model is called at for test scale ``s``: a
        scale-free model takes the pairs' real scale (HR size over LR
        size), any other the nominal one, as the JAX tester passes them."""
        if self.paras.get("scale_free"):
            return float(pairs[0][s]["real_sr_scale"])
        return float(s)

    def inference_patient(self, ds):
        """SR all slices of a patient; returns (per-slice {scale: HWC},
        the test pairs).

        Whole-slice by default (the reference example configs run the
        full LR slice through the net, trans_sr_tester.py:141-146), or
        tiled when ``tiled_inference = True`` (basic_dataset.py:347-449).
        """
        pairs = [ds.get_test_pair(i) for i in range(ds.test_len())]
        recs = [dict() for _ in pairs]
        tiled = self.paras.get("tiled_inference", False) and not self.bicubic
        for s in self.sr_scales:
            lr = np.concatenate([p[s]["in"] for p in pairs], axis=0)
            if self.bicubic:
                out = np.stack([ops.resize(x, p[s]["gt"].shape[:2])
                                for x, p in zip(lr, pairs)])
            elif tiled:
                out = self._tiled_inference(lr, s, pairs)
            else:
                out = self.forward(lr, self.model_scale(s, pairs)).cpu().numpy()
            if self.residual_scale > 0 and not self.bicubic:
                out = residual_blend(out, lr, self.residual_scale)
            for i in range(len(pairs)):
                recs[i][s] = out[i]
        return recs, pairs

    def _tiled_inference(self, lr: np.ndarray, s: float, pairs) -> np.ndarray:
        """Patch-unfold -> SR each chunk of patches -> overlap-normalized
        fold, on the device."""
        scale = self.model_scale(s, pairs)
        return tiled_sr(lambda x: self.forward(x, scale), lr,
                        pairs[0][s]["gt"].shape, self.paras, self.device,
                        self.mesh.size)

    def _sync(self):
        for dev in self.mesh.local_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- evaluation with resume (basic_tester.py:147-189) -----------------------

    def evaluation(self, case_name: str, ds) -> Dict:
        report_path = join(self.dirs["eva_reports"],
                           f"{case_name}_eva_reports.npy")
        if exists(report_path):
            self.write_log(f"{case_name}: cached report found, skipping inference")
            return np.load(report_path, allow_pickle=True).item()

        self._sync()
        t0 = time.time()
        recs, pairs = self.inference_patient(ds)
        self._sync()
        infer_cost = time.time() - t0

        report = self.eva_func(recs, pairs)
        if isinstance(report, dict):
            meta = {"inference_time_cost": infer_cost, "num_slices": len(recs)}
            np.save(report_path, {"report": report, **meta})
        save_scales = self.paras.get("sr_scales_for_saving", [])
        to_save = {
            f"x{s}": np.stack([r[s] for r in recs])
            for s in save_scales if s in (self.sr_scales or [])
        }
        if to_save:
            np.savez_compressed(
                join(self.dirs["inference_results"],
                     f"{case_name}_inference_results.npz"), **to_save)
        self.write_log(
            f"{case_name}: {len(recs)} slices, inference {infer_cost:.2f}s "
            f"({len(recs) * len(self.sr_scales) / max(infer_cost, 1e-9):.1f} "
            "slices/s)")
        return {"report": report, "inference_time_cost": infer_cost,
                "num_slices": len(recs)}

    # -- main loop ---------------------------------------------------------------

    def test(self):
        all_reports: List = []
        for pid in self.patient_ids:
            self.write_log(_fancy(f"Testing patient {pid}"))
            ds = make_test_dataset(self.paras, [pid])
            result = self.evaluation(pid, ds)
            all_reports.append(result["report"])

        stacked = self.eva_func.stack_eva_reports(all_reports)
        summary = self.eva_func.print(stacked)
        self.write_log(_fancy("All patients complete") + summary)
        np.save(join(self.output_root, "stacked_eva_reports.npy"), stacked)
        return stacked

    def write_log(self, plog: str):
        with open(self.log_file, "a") as f:
            f.write(plog + "\n")
        if self.verbose:
            print(plog, flush=True)


TransSRTester = SRTester
