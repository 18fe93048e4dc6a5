"""Data and tensor parallelism over torch.distributed ranks: the port of
gppvae_tpu/parallel/.

The JAX package's 1-D `data` mesh shards everything N-sized on its rows and
replicates everything R-sized or parameter-sized; the R×R Gram, the R×L
projection, the minibatch gradients and the metrics are psum'd. Its 2-D
`data × model` mesh (make_mesh_2d) also splits the large conv and dense
kernels by output features over `model` (shard_params_model_axis). Here one
process per device (launch.py) holds one data rank's rows (mesh.py) and
reduces exactly those quantities with explicit, counted collectives over the
axis they belong to (collectives.py); on a mesh with a model axis the large
weights split by output features (tensor.py) and each split layer completes
its output over the model row. The trainers, `ops.factor_prep`, the GP layer
and serving take the rank's group as `group=` (a DataGroup, or a MeshGroup
of the 2-D mesh; None = one process). dryrun.py holds one epoch on `world`
ranks against one process, and the rank functions the tests run.
"""

from gppvae_tpu_torch.parallel.collectives import (
    all_reduce,
    all_reduce_grads,
    all_reduce_sum,
    broadcast,
    check_replicated,
    copy_to_model,
    gather,
    gather_columns,
    summary,
)
from gppvae_tpu_torch.parallel.launch import RankPool, run_ranks
from gppvae_tpu_torch.parallel.mesh import (
    DataGroup,
    MeshGroup,
    padded_rows,
    replicate,
    row_block,
    shard_rows,
    trim_to_multiple,
)

__all__ = [
    "DataGroup", "MeshGroup", "RankPool", "all_reduce", "all_reduce_grads", "all_reduce_sum",
    "broadcast", "check_replicated", "copy_to_model", "gather", "gather_columns",
    "padded_rows", "replicate", "row_block", "run_ranks", "shard_rows", "summary",
    "trim_to_multiple",
]
