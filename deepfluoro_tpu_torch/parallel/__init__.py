from deepfluoro_tpu_torch.parallel.mesh import Axis, Mesh, make_mesh
from deepfluoro_tpu_torch.parallel.multihost import (
    initialize,
    is_writer,
    local_batch_slice,
    local_shard_indices,
    process_count,
    process_index,
    run_ranks,
)
from deepfluoro_tpu_torch.parallel.sharding import average_gradients, shard_rows, sync_batch_norm
from deepfluoro_tpu_torch.parallel.tensor import gather_state, shard_channels

__all__ = [
    "Axis",
    "Mesh",
    "make_mesh",
    "initialize",
    "is_writer",
    "local_batch_slice",
    "local_shard_indices",
    "process_count",
    "process_index",
    "run_ranks",
    "average_gradients",
    "shard_rows",
    "sync_batch_norm",
    "gather_state",
    "shard_channels",
]
