"""Data parallelism of the port on ``torch.distributed`` (counterpart of
``rdst_tpu/parallel``): meshes from the config's ``mesh_shape`` /
``mesh_axes`` (:mod:`.mesh`), the collectives of the data axis
(:mod:`.collectives`) and the launcher of its ranks (:mod:`.launch`)."""

from rdst_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_mesh_from_paras,
    data_parallel,
    initialize_distributed,
    make_mesh,
    make_mesh_from_paras,
    replicate_module,
    shard_batch,
    shard_batch_padded,
)
