"""Serving for the port: a live model with batch buckets, and the
stdlib HTTP server and client (counterparts of ``rdst_tpu/serving``).

The AOT bundle (``jax.export`` StableHLO) has no counterpart yet: it
waits for a later slice.
"""

from rdst_tpu_torch.serving.export import LiveModel  # noqa: F401
