"""SR generators of the port (``build_generator`` names them)."""

from rdst_tpu_torch.models.registry import build_generator  # noqa: F401
