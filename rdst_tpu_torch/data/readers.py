"""Concrete medical dataset families: OASIS, BraTS, ACDC, COVID-CT.

The port's own copy of ``rdst_tpu/data/readers.py`` (numpy and the standard
library only), kept so that the port imports nothing of ``rdst_tpu``.

Loading semantics follow the reference readers
(upstream datasets/{OASIS,BraTS,ACDC,CovidCT}_dataset.py):

* OASIS: Analyze ``*masked_gfc.img`` volumes, axis swap by ``dim``,
  drop empty slices (sum>0), per-patient min/max normalize, fixed margin
  trim; FSL_SEG labels for the seg-loss variant (OASIS_dataset.py:57-96).
* BraTS: label volume picks the slice mask (sum>100), label 4 -> 3,
  modalities normalized independently and stacked as channels
  (BraTS_dataset.py:83-118).
* ACDC: cine frames ``*_frame*_gt.nii.gz`` select slices by label,
  centre crop 128 (ACDC_dataset.py:82-128).
* COVID: CT volume + ``mask/`` labels, centre crop 512
  (CovidCT_dataset.py:59-120).

``toy_problem`` truncates every dataset to 2 patients (the de-facto
fast fixture).
"""

from __future__ import annotations

from glob import glob
from os.path import join
from typing import List

import numpy as np

from rdst_tpu_torch.data import io, ops


def glob_one(pattern: str) -> str:
    matches = glob(pattern)
    if not matches:
        raise FileNotFoundError(f"no volume matches {pattern}")
    return matches[0]
from rdst_tpu_torch.data.datasets import (
    MultiSRTestDataset,
    MultiSRTrainDataset,
    select_slices,
    thread_map,
)


# -- OASIS --------------------------------------------------------------------

class OASISLoaderMixin:
    IMAGE_SUBDIR = join("PROCESSED", "MPRAGE", "T88_111")
    LABEL_SUBDIR = "FSL_SEG"

    def _load_oasis(self, paras, patient_ids: List[str]):
        self.dim = paras.medical_image_dim_oasis
        self.margin = paras.margin_oasis
        if paras.toy_problem:
            patient_ids = patient_ids[:2]
        self.patient_ids = list(patient_ids)
        for pid in self.patient_ids:
            path = glob_one(join(paras.data_folder, pid, self.IMAGE_SUBDIR, "*masked_gfc.img"))
            vol = io.load(path).get_fdata()
            vol = np.swapaxes(vol, 0, self.dim)
            vol, mask = select_slices(vol, threshold=0.0)
            self.masks[pid] = mask
            vol, vmin, vmax = ops.normalize(vol)
            self.norm_paras[pid] = [vmin, vmax]
            self.hr_images.extend(list(vol))
            self.img_ids += [pid] * int(mask.sum())
        trim = lambda img: ops.margin_trim(img, self.margin)  # noqa: E731
        self.hr_images = thread_map(trim, self.hr_images, paras.multi_threads)

    def _load_oasis_labels(self, paras):
        labels = []
        for pid in self.patient_ids:
            path = glob_one(join(paras.data_folder, pid, self.LABEL_SUBDIR, "*_fseg.img"))
            lab = io.load(path).get_fdata()
            lab = np.swapaxes(lab, 0, self.dim)
            lab = lab[self.masks[pid]]
            labels.extend(list(lab))
        trim = lambda img: ops.margin_trim(img, self.margin)  # noqa: E731
        return thread_map(trim, labels, paras.multi_threads)


class OASISMultiSRTrain(OASISLoaderMixin, MultiSRTrainDataset):
    def __init__(self, paras):
        super().__init__()
        self._load_oasis(paras, paras.training_patient_ids_oasis)
        self.finalize(paras)


class OASISMultiSRTest(OASISLoaderMixin, MultiSRTestDataset):
    def __init__(self, paras, patient_ids: List[str]):
        super().__init__()
        self._load_oasis(paras, patient_ids)
        self.finalize(paras)


class OASISSegSRTrain(OASISMultiSRTrain):
    """Adds aligned segmentation labels to every batch (seg-UNet loss)."""

    def __init__(self, paras):
        super().__init__(paras)
        raw_labels = self._load_oasis_labels(paras)
        pad = ops.ImagePadding(
            raw_labels[0].shape[:2], self.get_hr_patch_size(max(self.sr_scales))
        )
        self.segmentation_labels = thread_map(pad.pad, raw_labels, paras.multi_threads)

    def sample(self, rng: np.random.Generator):
        ids = self.sample_ids(rng)
        sr_factor = float(rng.choice(self.sr_scales))
        lr_size = self.get_lr_patch_size(sr_factor)
        hr_size = self.get_hr_patch_size(sr_factor)

        hr_patches, labels = [], []
        for i in ids:
            img, lab = ops.paired_random_crop(
                self.hr_images[i], self.segmentation_labels[i], hr_size, 1, 0, rng
            )
            if self.augmentation:
                # same dihedral transform for the patch AND its labels,
                # matching the base sampler (datasets.py sample)
                k = int(rng.integers(8))
                img, lab = ops.dihedral(img, k), ops.dihedral(lab, k)
            hr_patches.append(img)
            labels.append(lab)
        lr_patches = [ops.resize(p, lr_size, "cubic", self.blur_method) for p in hr_patches]
        batch = {
            "in": ops.stack_to_nhwc(lr_patches),
            "out": ops.stack_to_nhwc(hr_patches),
            "sr_factor": sr_factor,
            "real_sr_scale": hr_size / lr_size,
            "res": [],
            "seg_gt": ops.stack_to_nhwc(labels),
        }
        if self.return_res_image:
            batch["res"] = ops.stack_to_nhwc([ops.resize(p, hr_size) for p in lr_patches])
        return batch


# -- BraTS --------------------------------------------------------------------

class BraTSLoaderMixin:
    def _brats_patient_dir(self, root, pid):
        group = pid.split("_")[0]
        return join(root, group, pid[len(group) + 1 :]), pid[len(group) + 1 :]

    def _load_brats(self, paras, patient_ids: List[str]):
        self.dim = paras.medical_image_dim_brats
        self.margin = paras.margin_brats
        self.modalities = list(paras.modalities_brats)
        if paras.toy_problem:
            patient_ids = patient_ids[:2]
        self.patient_ids = list(patient_ids)
        for pid in self.patient_ids:
            pdir, name = self._brats_patient_dir(paras.data_folder, pid)
            lab = io.load(join(pdir, f"{name}_seg.nii.gz")).get_fdata()
            lab = np.swapaxes(lab, 0, self.dim)
            lab, mask = select_slices(lab, threshold=100.0)
            self.masks[pid] = mask
            del lab  # only the slice-selection mask is used downstream

            stacked, ranges = [], []
            for m in self.modalities:
                vol = io.load(join(pdir, f"{name}_{m}.nii.gz")).get_fdata()
                vol = np.swapaxes(vol, 0, self.dim)
                vol, _ = select_slices(vol, mask=mask)
                vol, vmin, vmax = ops.normalize(vol)
                stacked.append(vol)
                ranges.append([vmin, vmax])
            self.norm_paras[pid] = ranges
            multi = np.stack(stacked, axis=-1)  # (S, H, W, C)
            self.hr_images.extend(list(multi))
            self.img_ids += [pid] * multi.shape[0]
        trim = lambda img: ops.margin_trim(img, self.margin)  # noqa: E731
        self.hr_images = thread_map(trim, self.hr_images, paras.multi_threads)


class BraTSMultiSRTrain(BraTSLoaderMixin, MultiSRTrainDataset):
    def __init__(self, paras):
        super().__init__()
        self._load_brats(paras, paras.training_patient_ids_brats)
        self.finalize(paras)


class BraTSMultiSRTest(BraTSLoaderMixin, MultiSRTestDataset):
    def __init__(self, paras, patient_ids: List[str]):
        super().__init__()
        self._load_brats(paras, patient_ids)

        from rdst_tpu_torch.metrics.evaluation import MultiModalityMetaSREvaluation

        def factory(metrics, mode):
            return MultiModalityMetaSREvaluation(
                self.modalities, metrics, list(paras.test_sr_scales), paras.eva_gpu_id, mode
            )

        self.finalize(paras, evaluation_factory=factory)


# -- ACDC ---------------------------------------------------------------------

class ACDCLoaderMixin:
    def _load_acdc(self, paras, patient_ids: List[str]):
        self.dim = paras.medical_image_dim_acdc
        self.centre_crop_size = paras.crop_size_acdc
        if paras.toy_problem:
            patient_ids = patient_ids[:2]
        self.patient_ids = list(patient_ids)
        for pid in self.patient_ids:
            frames = sorted(glob(join(paras.data_folder, pid, f"{pid}_frame*_gt.nii.gz")))
            pid_slices, ranges = [], {}
            for label_path in frames:
                lab = io.load(label_path).get_fdata()
                lab = np.swapaxes(lab, 0, self.dim)
                lab, mask = select_slices(lab, threshold=100.0)
                frame_path = label_path.replace("_gt", "")
                vol = io.load(frame_path).get_fdata()
                vol = np.swapaxes(vol, 0, self.dim)
                vol, _ = select_slices(vol, mask=mask)
                vol, vmin, vmax = ops.normalize(vol)
                ranges[frame_path.rsplit("/", 1)[-1]] = [vmin, vmax]
                pid_slices.append(vol)
            data = np.concatenate(pid_slices, axis=0)
            if data.ndim == 3:
                data = data[..., None]
            self.norm_paras[pid] = ranges
            self.hr_images.extend(list(data))
            self.img_ids += [pid] * data.shape[0]
        crop = lambda img: ops.centre_crop(img, self.centre_crop_size)  # noqa: E731
        self.hr_images = thread_map(crop, self.hr_images, paras.multi_threads)


class ACDCMultiSRTrain(ACDCLoaderMixin, MultiSRTrainDataset):
    def __init__(self, paras):
        super().__init__()
        self._load_acdc(paras, paras.training_patient_ids_acdc)
        self.finalize(paras)


class ACDCMultiSRTest(ACDCLoaderMixin, MultiSRTestDataset):
    def __init__(self, paras, patient_ids: List[str]):
        super().__init__()
        self._load_acdc(paras, patient_ids)
        self.finalize(paras)


# -- COVID-CT -----------------------------------------------------------------

class CovidCTLoaderMixin:
    def _load_covid(self, paras, patient_ids: List[str]):
        self.dim = paras.medical_image_dim_covid
        self.centre_crop_size = 512
        if paras.toy_problem:
            patient_ids = patient_ids[:2]
        self.patient_ids = list(patient_ids)
        for pid in self.patient_ids:
            vol = io.load(join(paras.data_folder, f"{pid}.nii.gz")).get_fdata()
            lab = io.load(join(paras.data_folder, "mask", f"{pid}.nii.gz")).get_fdata()
            vol = np.swapaxes(vol, 0, self.dim)
            lab = np.swapaxes(lab, 0, self.dim)
            lab, mask = select_slices(lab, threshold=100.0)
            vol, _ = select_slices(vol, mask=mask)
            vol, vmin, vmax = ops.normalize(vol)
            self.norm_paras[pid] = [vmin, vmax]
            if vol.ndim == 3:
                vol = vol[..., None]
            self.hr_images.extend(list(vol))
            self.img_ids += [pid] * vol.shape[0]
        crop = lambda img: ops.centre_crop(img, self.centre_crop_size)  # noqa: E731
        self.hr_images = thread_map(crop, self.hr_images, paras.multi_threads)


class CovidCTMultiSRTrain(CovidCTLoaderMixin, MultiSRTrainDataset):
    def __init__(self, paras):
        super().__init__()
        self._load_covid(paras, paras.training_patient_ids_covid)
        self.finalize(paras)


class CovidCTMultiSRTest(CovidCTLoaderMixin, MultiSRTestDataset):
    def __init__(self, paras, patient_ids: List[str]):
        super().__init__()
        self._load_covid(paras, patient_ids)
        self.finalize(paras)


# -- dispatch (train.py:50-71 selects by data_folder substring) ----------------

def make_train_valid_datasets(paras, seg_loss: bool = False):
    folder = paras.data_folder
    if "OASIS" in folder:
        train = OASISSegSRTrain(paras) if seg_loss else OASISMultiSRTrain(paras)
        valid = OASISMultiSRTest(paras, paras.validation_patient_ids_oasis)
    elif "BraTS" in folder:
        train = BraTSMultiSRTrain(paras)
        valid = BraTSMultiSRTest(paras, paras.validation_patient_ids_brats)
    elif "ACDC" in folder:
        train = ACDCMultiSRTrain(paras)
        valid = ACDCMultiSRTest(paras, paras.validation_patient_ids_acdc)
    elif "COVID" in folder:
        train = CovidCTMultiSRTrain(paras)
        valid = CovidCTMultiSRTest(paras, paras.validation_patient_ids_covid)
    else:
        raise ValueError("Only support data: [OASIS, BraTS, ACDC, COVID]")
    return train, valid


def make_test_dataset(paras, patient_ids):
    folder = paras.data_folder
    if "OASIS" in folder:
        return OASISMultiSRTest(paras, patient_ids)
    if "BraTS" in folder:
        return BraTSMultiSRTest(paras, patient_ids)
    if "ACDC" in folder:
        return ACDCMultiSRTest(paras, patient_ids)
    if "COVID" in folder:
        return CovidCTMultiSRTest(paras, patient_ids)
    raise ValueError("Only support data: [OASIS, BraTS, ACDC, COVID]")


def testing_patient_ids(paras):
    folder = paras.data_folder
    if "OASIS" in folder:
        return list(paras.testing_patient_ids_oasis)
    if "BraTS" in folder:
        return list(paras.testing_patient_ids_brats)
    if "ACDC" in folder:
        return list(paras.testing_patient_ids_acdc)
    if "COVID" in folder:
        return list(paras.testing_patient_ids_covid)
    raise ValueError("Only support data: [OASIS, BraTS, ACDC, COVID]")
