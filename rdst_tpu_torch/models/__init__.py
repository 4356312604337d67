"""SR generators of the port: RDST and SwinIR."""

from rdst_tpu_torch.models.registry import build_generator  # noqa: F401
