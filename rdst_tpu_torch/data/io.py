"""Minimal native NIfTI-1 / Analyze 7.5 volume IO (no nibabel dependency).

The port's own copy of ``rdst_tpu/data/io.py`` (numpy and the standard
library only), kept so that the port imports nothing of ``rdst_tpu``.

The reference loads medical volumes via nibabel (e.g.
upstream datasets/OASIS_dataset.py:72-74 loads Analyze ``.img``
pairs, BraTS/ACDC/COVID load ``.nii.gz``). This module implements the
two on-disk formats natively:

* Analyze 7.5: 348-byte ``.hdr`` + raw ``.img`` payload.
* NIfTI-1: 348-byte header (magic ``n+1``/``ni1``), optional gzip,
  single-file ``.nii``/``.nii.gz`` or ``.hdr``/``.img`` pairs.

Only the features the datasets use are implemented: dtype, dims,
scl_slope/inter, vox_offset. Data is returned as float64 via
``get_fdata()``-compatible semantics (scale applied), matching what the
reference pipelines see from nibabel.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# NIfTI/Analyze datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class VolumeHeader:
    shape: Tuple[int, ...]
    dtype: np.dtype
    vox_offset: int
    scl_slope: float
    scl_inter: float
    byteorder: str  # '<' or '>'
    is_nifti: bool


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_header(raw: bytes) -> VolumeHeader:
    if len(raw) < 348:
        raise ValueError("header too short for NIfTI-1/Analyze")
    # sizeof_hdr decides byte order (348 little or big endian)
    (sizeof_hdr,) = struct.unpack("<i", raw[:4])
    bo = "<" if sizeof_hdr == 348 else ">"
    if bo == ">":
        (sizeof_hdr,) = struct.unpack(">i", raw[:4])
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1/Analyze header")

    dim = struct.unpack(bo + "8h", raw[40:56])
    ndim = max(min(dim[0], 7), 1)
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack(bo + "h", raw[70:72])
    (vox_offset,) = struct.unpack(bo + "f", raw[108:112])
    magic = raw[344:348]
    is_nifti = magic[:3] in (b"n+1", b"ni1")
    if is_nifti:
        (scl_slope,) = struct.unpack(bo + "f", raw[112:116])
        (scl_inter,) = struct.unpack(bo + "f", raw[116:120])
    else:
        scl_slope, scl_inter = 1.0, 0.0
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported datatype code {datatype}")
    return VolumeHeader(
        shape=shape,
        dtype=np.dtype(_DTYPES[datatype]).newbyteorder(bo),
        vox_offset=int(vox_offset) if is_nifti and magic[:3] == b"n+1" else 0,
        # NIfTI-1 / nibabel semantics: slope 0 OR NaN means "no scaling"
        # (real-world files ship scl_slope=nan; applying it literally
        # would NaN the whole volume); a NaN intercept likewise drops out
        scl_slope=(float(scl_slope)
                   if np.isfinite(scl_slope) and scl_slope != 0.0 else 1.0),
        scl_inter=float(scl_inter) if np.isfinite(scl_inter) else 0.0,
        byteorder=bo,
        is_nifti=is_nifti,
    )


def _sibling_img(path: str) -> Optional[str]:
    base, ext = os.path.splitext(path)
    if ext == ".gz":
        base, ext = os.path.splitext(base)
    if ext != ".hdr":
        return None
    for cand in (base + ".img", base + ".img.gz"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no .img payload next to {path}")


def load(path: str) -> "Volume":
    """Load a ``.nii[.gz]`` / ``.hdr`` / ``.img`` volume."""
    base, ext = os.path.splitext(path)
    if ext == ".gz":
        base, ext = os.path.splitext(base)
    if ext == ".img":  # allow passing the payload; header is the sibling
        for cand in (base + ".hdr", base + ".hdr.gz"):
            if os.path.exists(cand):
                return load(cand)
        raise FileNotFoundError(f"no .hdr next to {path}")

    raw = _read_bytes(path)
    hdr = _parse_header(raw)

    img_path = _sibling_img(path)
    if img_path is not None:  # .hdr/.img pair
        payload = _read_bytes(img_path)
        offset = 0
    else:  # single-file .nii
        payload = raw
        offset = max(hdr.vox_offset, 352)

    # validate against crafted/corrupt headers BEFORE allocating: a
    # negative dim makes np.prod/ frombuffer misbehave confusingly, and
    # an undersized payload should name the file, not raise a raw
    # buffer error from numpy internals
    if any(d < 1 for d in hdr.shape):
        raise ValueError(f"{path}: invalid volume dims {hdr.shape}")
    count = int(np.prod(hdr.shape, dtype=np.int64))
    need = offset + count * hdr.dtype.itemsize
    if need > len(payload):
        raise ValueError(
            f"{path}: header declares {hdr.shape} {hdr.dtype} "
            f"({need} bytes incl. offset {offset}) but the payload has "
            f"only {len(payload)} bytes — truncated or corrupt volume")
    data = np.frombuffer(payload, dtype=hdr.dtype, count=count, offset=offset)
    data = data.reshape(hdr.shape, order="F")
    return Volume(data, hdr)


class Volume:
    """nibabel-like handle: ``.shape``, ``.get_fdata()``."""

    def __init__(self, data: np.ndarray, header: VolumeHeader):
        self._data = data
        self.header = header

    @property
    def shape(self):
        return self._data.shape

    def get_fdata(self) -> np.ndarray:
        out = self._data.astype(np.float64)
        if self.header.scl_slope != 1.0 or self.header.scl_inter != 0.0:
            out = out * self.header.scl_slope + self.header.scl_inter
        return out


def _build_header(shape, dtype, nifti: bool, single_file: bool) -> bytes:
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [len(shape)] + list(shape) + [1] * (7 - len(shape))
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(dtype)])
    struct.pack_into("<h", hdr, 72, np.dtype(dtype).itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * len(shape) + [0.0] * (7 - len(shape))))
    if nifti:
        struct.pack_into("<f", hdr, 108, 352.0 if single_file else 0.0)
        struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
        struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
        hdr[344:348] = b"n+1\x00" if single_file else b"ni1\x00"
    return bytes(hdr)


def save(path: str, data: np.ndarray) -> None:
    """Save a volume. ``.nii``/``.nii.gz`` single-file NIfTI-1, or
    ``.hdr``/``.img`` Analyze pair (pass either member)."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    payload = np.asfortranarray(data).tobytes(order="F")

    gz = path.endswith(".gz")
    stem = path[:-3] if gz else path
    base, ext = os.path.splitext(stem)

    if ext == ".nii":
        blob = _build_header(data.shape, data.dtype, nifti=True, single_file=True)
        blob += b"\x00" * 4 + payload  # pad to vox_offset 352
        _write(path, blob, gz)
    elif ext in (".hdr", ".img"):
        hdr = _build_header(data.shape, data.dtype, nifti=False, single_file=False)
        _write(base + ".hdr", hdr, False)
        _write(base + ".img", payload, False)
    else:
        raise ValueError(f"unsupported extension: {path}")


def _write(path: str, blob: bytes, gz: bool) -> None:
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
