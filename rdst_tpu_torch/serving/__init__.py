"""Serving for the port: a live model and an exported bundle with batch
buckets (one CUDA graph an entry and bucket on the card), and the stdlib
HTTP server and client (counterparts of ``rdst_tpu/serving``).
"""

from rdst_tpu_torch.serving.export import (LiveModel,  # noqa: F401
                                           ServingBundle, export_bundle)
