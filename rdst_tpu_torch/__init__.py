"""rdst_tpu_torch — the PyTorch / CUDA port of ``rdst_tpu`` for one NVIDIA H100.

A second package beside the JAX one. It keeps the JAX package's module
paths and names so each piece has an obvious counterpart, imports only
``torch``, ``numpy`` and the standard library, and runs its kernels as
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound with ``ctypes``.

This slice serves RDST-E1 x4 in float32: config -> msgpack weights ->
``models.build_generator`` -> ``serving`` (live model + HTTP server).
Every Swin block of that path runs the kernel
``kernels.swin_block.fused_swin_block``.
"""

__version__ = "0.1.0"

from rdst_tpu_torch.config import ParametersLoader  # noqa: F401
