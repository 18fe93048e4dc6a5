"""Data parallelism over torch.distributed ranks: the port of gppvae_tpu/parallel/.

The JAX package's 1-D `data` mesh shards everything N-sized on its rows and
replicates everything R-sized or parameter-sized; the R×R Gram, the R×L
projection, the minibatch gradients and the metrics are psum'd. Here `world`
processes (launch.py) each hold one rank's rows (mesh.py) and reduce exactly
those quantities with explicit, counted collectives (collectives.py); the
trainers, `ops.factor_prep`, the GP layer and serving take the DataGroup as
`group=` (None = one process). dryrun.py holds one epoch on `world` ranks
against one process, and the rank functions the tests run.

The 2-D `data × model` mesh (tensor parallelism) is not ported yet.
"""

from gppvae_tpu_torch.parallel.collectives import (
    all_reduce,
    all_reduce_grads,
    all_reduce_sum,
    broadcast,
    check_replicated,
    summary,
)
from gppvae_tpu_torch.parallel.launch import RankPool, run_ranks
from gppvae_tpu_torch.parallel.mesh import (
    DataGroup,
    padded_rows,
    replicate,
    row_block,
    shard_rows,
    trim_to_multiple,
)

__all__ = [
    "DataGroup", "RankPool", "all_reduce", "all_reduce_grads", "all_reduce_sum", "broadcast",
    "check_replicated", "padded_rows", "replicate", "row_block", "run_ranks", "shard_rows",
    "summary", "trim_to_multiple",
]
