"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Each source in ``rdst_tpu_torch/csrc/`` is compiled at first use by one
``nvcc`` call for ``sm_90a`` into a plain-C shared library under
``build/rdst_tpu_torch/`` at the repository root, named by the hash of
the source and the flags, so an edit rebuilds and an unchanged source
loads the library already built. Nothing is compiled or loaded when a
module is imported. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "rdst_tpu_torch"

SOURCES = ("swin_block.cu",)  # every kernel source of the port

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, the ``PATH``, or the
    toolkit's default prefix ``/usr/local/cuda``."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "compiled from rdst_tpu_torch/csrc at first use")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` goes."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library's path. The compiler's output (ptxas register and
    shared-memory report included) is kept beside it as ``.log``."""
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build_log(source: str) -> str:
    """The compiler output kept by :func:`build` ('' before a build)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load the library of ``csrc/<source>`` (once
    per process)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _libs[source] = lib
        return lib
