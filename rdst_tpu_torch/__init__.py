"""rdst_tpu_torch — the PyTorch / CUDA port of ``rdst_tpu`` for one NVIDIA H100.

A second package beside the JAX one. It keeps the JAX package's module
paths and names so each piece has an obvious counterpart, imports only
``torch``, ``numpy``, ``scipy`` and the standard library, and runs its
kernels as hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``.

It serves RDST-E1 x4 (``serving``: live model + HTTP server) in float32
on the f32 block kernel and in bfloat16 on the RDSTB, pair and fast
block kernels, and trains it (``python -m rdst_tpu_torch.train``: the
data pipeline, the trainer, flax-readable snapshots) with each bf16
DSTL pair on the train-pair forward and backward kernels. It serves
SwinIR-std x4 in bfloat16 on the fast block kernel with int8 qkv
operands and trains it with each Swin block on the block-train forward
and backward kernels.
"""

__version__ = "0.1.0"

from rdst_tpu_torch.config import ParametersLoader  # noqa: F401
