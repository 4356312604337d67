"""SR generators of the port (this slice: RDST)."""

from rdst_tpu_torch.models.registry import build_generator  # noqa: F401
