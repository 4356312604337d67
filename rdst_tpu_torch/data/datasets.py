"""Dataset base classes: slice stores, multi-SR train sampling, test pairs.

The port's own copy of ``rdst_tpu/data/datasets.py`` (numpy and the standard
library only), kept so that the port imports nothing of ``rdst_tpu``.

Re-design of the reference dataset layer
(upstream datasets/basic_dataset.py:24-326) for the TPU pipeline:

* same **batch-in-dataset** semantics — one call produces a whole batch
  of random HR crops sharing a single randomly-drawn SR factor, with LR
  inputs synthesized by cubic downscale (+ optional blur)
  (basic_dataset.py:190-217);
* arrays are **NHWC float32 numpy** end to end (TPU-native layout)
  instead of torch NCHW tensors;
* randomness flows through an explicit ``np.random.Generator`` so the
  stream is reproducible and per-host shardable, replacing the global
  np.random state;
* test pairs keep the reference's per-scale dict shape: LR is the HR
  downscaled by the *max* scale, GT per scale is resize(ori, lr*s)
  (basic_dataset.py:258-301).
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from rdst_tpu_torch.data import ops


def thread_map(fn: Callable, items: Sequence, threads: int = 8) -> List:
    """Parallel map over slices (cv2/numpy release the GIL)."""
    if threads <= 1 or len(items) < 4:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=threads) as ex:
        return list(ex.map(fn, items))


def select_slices(vol: np.ndarray, mask: Optional[np.ndarray] = None, threshold: float = 0.0):
    """Keep slices (axis 0) whose intensity sum exceeds ``threshold``."""
    if mask is None:
        mask = vol.sum(axis=tuple(range(1, vol.ndim))) > threshold
    return vol[mask], mask


class SliceStore:
    """A flat list of HWC slices with per-patient bookkeeping."""

    def __init__(self):
        self.hr_images: List[np.ndarray] = []
        self.img_ids: List[str] = []
        self.masks: Dict[str, np.ndarray] = {}
        self.norm_paras: Dict[str, object] = {}

    def __len__(self):
        return len(self.hr_images)

    normalize = staticmethod(ops.normalize)
    resize = staticmethod(ops.resize)


class MultiSRTrainDataset(SliceStore):
    """Batch-in-dataset training sampler over preprocessed HR slices."""

    def __init__(self):
        super().__init__()
        self.sr_scales: List[float] = []
        self.batch_size = 0
        self.lr_patch_size = 0
        self.return_res_image = False
        self.blur_method: Optional[str] = None
        self.lr_image_size_remain = False
        self.augmentation = False
        self.mean = [0.0]
        self.std = [1.0]

    # patch-size rules (basic_dataset.py:219-223)
    def get_lr_patch_size(self, s) -> int:
        return self.lr_patch_size

    def get_hr_patch_size(self, s) -> int:
        return int(self.lr_patch_size * s)

    def finalize(self, paras):
        """Pad slices to the max HR patch and compute dataset statistics."""
        self.sr_scales = list(paras.all_sr_scales)
        self.batch_size = paras.batch_size
        self.lr_patch_size = paras.patch_size
        self.return_res_image = (paras.return_res_image
                                 or float(paras.get("residual_scale", 0) or 0) > 0)
        self.blur_method = paras.blur_method or None
        self.lr_image_size_remain = paras.lr_image_size_remain
        # the reference declares this key but never implements it; here it
        # enables dihedral augmentation of HR patches before LR synthesis
        self.augmentation = paras.get("augmentation", False)
        norm = paras.normal_inputs or ""

        pad = ops.ImagePadding(
            self.hr_images[0].shape[:2], self.get_hr_patch_size(max(self.sr_scales))
        )
        self.hr_images = thread_map(pad.pad, self.hr_images, paras.multi_threads)

        if self.lr_image_size_remain:
            self.batch_size = 1
            self.return_res_image = True

        channels = self.hr_images[0].shape[-1]
        self.mean = [0.0] * channels
        self.std = [1.0] * channels
        if "zero_mean" in norm or "unit_std" in norm:
            # only materialize the full-dataset stack (a float64 copy of
            # every slice) when the stats are actually requested
            stack = np.stack(self.hr_images)
            if "zero_mean" in norm:
                self.mean = list(np.mean(stack, axis=(0, 1, 2)))
            if "unit_std" in norm:
                self.std = list(np.std(stack, axis=(0, 1, 2)))
            del stack

    def sample_ids(self, rng: np.random.Generator) -> np.ndarray:
        """Batch slice indices — the reference's no-replacement semantics
        (basic_dataset.py:192) with an actionable undersized-corpus error.
        Shared by every sample() override."""
        if len(self) < self.batch_size:
            raise ValueError(
                f"training corpus has only {len(self)} slices but "
                f"batch_size={self.batch_size} samples without replacement; "
                "reduce batch_size or provide more data")
        return rng.choice(len(self), self.batch_size, replace=False)

    def sample(self, rng: np.random.Generator) -> Dict[str, object]:
        """One training batch: same SR factor for all items (NHWC arrays)."""
        ids = self.sample_ids(rng)
        sr_factor = float(rng.choice(self.sr_scales))
        lr_size = self.get_lr_patch_size(sr_factor)
        hr_size = self.get_hr_patch_size(sr_factor)
        real_scale = hr_size / lr_size

        if self.lr_image_size_remain:
            hr_patches = [self.hr_images[i] for i in ids]
        else:
            hr_patches = [
                ops.random_crop(self.hr_images[i], hr_size, 0, rng) for i in ids
            ]
        if self.augmentation:
            hr_patches = [ops.dihedral(p, int(rng.integers(8))) for p in hr_patches]
        lr_patches = [
            ops.resize(p, lr_size, "cubic", self.blur_method) for p in hr_patches
        ]
        batch = {
            "in": ops.stack_to_nhwc(lr_patches),
            "out": ops.stack_to_nhwc(hr_patches),
            "sr_factor": sr_factor,
            "real_sr_scale": real_scale,
            "res": [],
        }
        if self.return_res_image:
            res = [ops.resize(p, hr_size) for p in lr_patches]
            batch["res"] = ops.stack_to_nhwc(res)
            if self.lr_image_size_remain:
                # the model maps the interpolated LR to the output size
                # (ZSSR), as the test pairs feed it; the JAX sampler leaves
                # 'in' at LR here, so the JAX trainer cannot train ZSSR
                batch["in"] = batch["res"]
        return batch

    def __getitem__(self, item):  # reference-compatible access
        return self.sample(np.random.default_rng())


class MultiSRTestDataset(SliceStore):
    """Per-slice multi-scale test pairs + evaluation function owners."""

    def __init__(self):
        super().__init__()
        self.test_sr_scales: List[float] = []
        self.lr_patch_size = 0
        self.lr_patch_stride = 0
        self.return_res_image = False
        self.blur_method: Optional[str] = None
        self.lr_image_size_remain = False
        self.quick_eva_func = None
        self._final_eva = None
        self.hr_image_region = None
        self.input_channels = 1

    def crop(self, img):
        return img

    def finalize(self, paras, evaluation_factory=None):
        self.test_sr_scales = list(paras.test_sr_scales)
        self.lr_patch_size = paras.patch_size
        self.lr_patch_stride = paras.get("test_lr_patch_stride", paras.patch_size)
        self.return_res_image = paras.return_res_image
        self.blur_method = paras.blur_method or None
        self.lr_image_size_remain = paras.lr_image_size_remain
        self.input_channels = self.hr_images[0].shape[-1]
        self.hr_image_region = self.hr_images[0].shape[:2]

        if evaluation_factory is None:
            from rdst_tpu_torch.metrics.evaluation import MetaSREvaluation

            def evaluation_factory(metrics, mode):
                return MetaSREvaluation(metrics, self.test_sr_scales, paras.eva_gpu_id, mode)

        self.quick_eva_func = evaluation_factory(paras.quick_eva_metrics, "mean")
        self._final_eva = (evaluation_factory, paras.eva_metrics)

    @functools.cached_property
    def final_eva_func(self):
        """The full report of ``eva_metrics``, built on first use: the
        tester scores ``eva_metrics_for_testing`` and never builds it, so
        a config whose ``eva_metrics`` lists a metric the port lacks
        (the shipped configs list ``fid``) still tests."""
        factory, metrics = self._final_eva
        return factory(metrics, "full")

    def test_len(self) -> int:
        return len(self.hr_images)

    def get_test_pair(self, item: int) -> Dict[float, Dict[str, object]]:
        ori = self.crop(self.hr_images[item])
        h, w = ori.shape[:2]
        smax = max(self.test_sr_scales)
        lr = ops.resize(ori, (int(h // smax), int(w // smax)), "cubic", self.blur_method)
        lr_h, lr_w = lr.shape[:2]

        sample = {}
        for s in self.test_sr_scales:
            gt = ops.resize(ori, (int(lr_h * s), int(lr_w * s)))
            real = int(lr_h * s) / lr_h
            entry = {
                "in": ops.stack_to_nhwc([lr]),
                "gt": gt,
                "sr_factor": s,
                "real_sr_scale": real,
                "res": [],
            }
            if self.return_res_image or self.lr_image_size_remain:
                res = ops.resize(lr, gt.shape[:2])
                entry["res"] = ops.stack_to_nhwc([res])
                if self.lr_image_size_remain:
                    entry["in"] = entry["res"]
            sample[s] = entry
        return sample

    # reference-compatible accessors (trainers fetch eval funcs from datasets)
    def get_quick_eva_func(self):
        return self.quick_eva_func

    def get_final_eva_func(self):
        return self.final_eva_func

    def get_quick_eva_metrics(self):
        return self.quick_eva_func.get_metrics()

    def get_final_eva_metrics(self):
        return self.final_eva_func.get_metrics()
