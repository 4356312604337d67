"""rdst_tpu_torch — the PyTorch / CUDA port of ``rdst_tpu`` for one NVIDIA H100.

A second package beside the JAX one. It keeps the JAX package's module
paths and names so each piece has an obvious counterpart, imports only
``torch``, ``numpy`` and the standard library, and runs its
kernels as hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``.

It serves RDST-E1 x4 (``serving``: live model + HTTP server) in float32
on the f32 block kernel and in bfloat16 on the RDSTB, pair and fast
block kernels, and trains it (``python -m rdst_tpu_torch.train``: the
data pipeline, the trainer, flax-readable snapshots) with each bf16
DSTL pair on the train-pair forward and backward kernels. It serves
SwinIR-std x4 in bfloat16 on the fast block kernel with int8 qkv
operands and trains it with each Swin block on the block-train forward
and backward kernels. ``python -m rdst_tpu_torch.test`` scores a config's
trained weights by the ``test.py`` protocol (``runners/tester.py``).
The trainer also runs the fine-tune recipes: the VGG and seg-UNet
perceptual losses and the GAN step with its discriminator
(``losses/``), and FID scores the evaluations (``metrics/fid.py``).
MetaSR and a scale-free RDST serve and train at fractional scales. The
Swin-based model zoo builds from any RDST config by overrides
(``models/registry.py``): RDST-N, ESTSR, RDST's ``3conv`` / ``ape`` /
``remat`` options, the wavelet transformers and Swin-MLP, on the same
kernels.
"""

__version__ = "0.1.0"

from rdst_tpu_torch.config import ParametersLoader  # noqa: F401
