from paths_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ProcessMesh,
    make_mesh,
    mesh_from_config,
    pad_batch_indices,
    replicate,
)
