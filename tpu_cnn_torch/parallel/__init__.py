"""The mesh axes' serving half — the port of ``tpu_cnn.parallel``: the
(data, model) mesh and ``MeshEngine`` (``mesh``), the GPipe pipeline
(``pipeline``), the row-sharded spatial forward (``spatial``), the
multi-process engine over gloo (``multihost``) and the serving dry run
(``dryrun``)."""

from tpu_cnn_torch.parallel.mesh import (
    Mesh,
    MeshEngine,
    make_mesh,
    shard_batch,
    sharded_detect,
    sharded_forward,
)
from tpu_cnn_torch.parallel.multihost import (
    MultiHostEngine,
    allgather_to_host,
    global_image_batch,
    init_multihost,
    is_primary,
    local_rows,
    shutdown_multihost,
)
from tpu_cnn_torch.parallel.pipeline import (
    make_pipeline_mesh,
    pipelined_forward,
    split_stages,
)
from tpu_cnn_torch.parallel.spatial import (
    check_spatial_split,
    make_spatial_mesh,
    spatial_forward,
)

__all__ = [
    "Mesh",
    "MeshEngine",
    "make_mesh",
    "shard_batch",
    "sharded_forward",
    "sharded_detect",
    "make_pipeline_mesh",
    "pipelined_forward",
    "split_stages",
    "check_spatial_split",
    "make_spatial_mesh",
    "spatial_forward",
    "MultiHostEngine",
    "allgather_to_host",
    "global_image_batch",
    "local_rows",
    "init_multihost",
    "is_primary",
    "shutdown_multihost",
]
