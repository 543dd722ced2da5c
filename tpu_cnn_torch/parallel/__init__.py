"""The mesh axes — the port of ``tpu_cnn.parallel``: the (data, model)
mesh and ``MeshEngine`` (``mesh``), the GPipe pipeline (``pipeline``) and
its training twin (``pipeline_train``), the row-sharded spatial forward
(``spatial``) and its training twin (``spatial_train``), the
multi-process engine and training feed over gloo (``multihost``) and the
dry run (``dryrun``). The (data, model) and ZeRO-1 train steps live in
``train.train_cnn``."""

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
    global_batches,
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
from tpu_cnn_torch.parallel.pipeline_train import (
    make_pipeline_train_step,
    pipelined_float_logits,
)
from tpu_cnn_torch.parallel.spatial import (
    check_spatial_split,
    make_spatial_mesh,
    spatial_forward,
)
from tpu_cnn_torch.parallel.spatial_train import (
    make_spatial_train_step,
    spatial_float_logits,
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
    "make_pipeline_train_step",
    "pipelined_float_logits",
    "check_spatial_split",
    "make_spatial_mesh",
    "spatial_forward",
    "make_spatial_train_step",
    "spatial_float_logits",
    "MultiHostEngine",
    "allgather_to_host",
    "global_batches",
    "global_image_batch",
    "local_rows",
    "init_multihost",
    "is_primary",
    "shutdown_multihost",
]
