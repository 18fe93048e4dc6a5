"""The data mesh and the data × model mesh as torch.distributed ranks.

Counterpart of gppvae_tpu/parallel/mesh.py (`make_mesh`, `make_mesh_2d`,
`row_sharding`, `replicated`, `trim_to_multiple`, `shard_rows`). The JAX
package is one process over a mesh; here one process per device each hold
one data rank's contiguous block of the N-sized rows (images, Z, V, the
Taylor rows) and a replica of everything R-sized or parameter-sized, except
the weights that tensor parallelism splits (tensor.py). Every function that
reduces over ranks takes the rank's group explicitly, and `None` is the
single-process path. `launch.run_ranks` / `launch.RankPool` start the ranks.

A DataGroup is a rank of the 1-D mesh: its `rank` of `world` ranks, whose
process group is torch.distributed's default one. A MeshGroup is a rank of
the 2-D mesh of `data × model` ranks: global rank r sits at data index
r // model and model index r % model, the row-major order of
`make_mesh_2d`'s `devices[:n].reshape(data, model)`. Its `rank` and `world`
are the data axis's (the functions below and every row split read them),
its `model_rank` and `model_size` the model axis's, and it holds one process
group per axis: its data column (the ranks of its model index) and its model
row (the ranks of its data index). Ranks of one model row hold the same rows.

Rows are split after wrap-around padding to a multiple of the world size
(`padded_rows`, as gppvae_tpu/train/train_gppvae.py:647-667 pads the mesh's
shard axis): the padded rows carry weight 0, so a trainer zeroes their
latents and feature rows and they add nothing to any sum.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


AXES = ("data", "model", "world")


@dataclasses.dataclass
class DataGroup:
    """One rank of the 1-D data axis. `counts` tallies the collectives this
    rank issued: (kind, bytes per call) → calls (see collectives.summary)."""

    rank: int
    world: int
    device: torch.device
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    model_rank = 0  # no model axis: every weight is whole
    model_size = 1

    @property
    def global_rank(self) -> int:
        return self.rank

    def axis(self, name: str) -> tuple[str, object]:
        """(the label its collectives are counted under, its process group)
        for the axis `name`. On the 1-D mesh the world is the data axis: one
        label, the default group (None)."""
        if name not in ("data", "world"):
            raise ValueError(f"a DataGroup has the data axis only, not {name!r}")
        return "data", None

    def size(self, name: str) -> int:
        """The number of ranks on the axis `name`."""
        self.axis(name)
        return self.world

    def root(self, name: str) -> int:
        """The global rank of the first rank on this rank's axis `name`."""
        self.axis(name)
        return 0


@dataclasses.dataclass
class MeshGroup(DataGroup):
    """One rank of the 2-D data × model mesh (see the module docstring):
    `rank` of `world` on the data axis, `model_rank` of `model_size` on the
    model axis, `data_pg` / `model_pg` the process groups of its data column
    and its model row."""

    model_rank: int = 0
    model_size: int = 1
    data_pg: object = None
    model_pg: object = None

    @property
    def global_rank(self) -> int:
        return self.rank * self.model_size + self.model_rank

    def axis(self, name: str) -> tuple[str, object]:
        pgs = {"data": self.data_pg, "model": self.model_pg, "world": None}
        if name not in pgs:
            raise ValueError(f"unknown axis {name!r}; want one of {AXES}")
        return name, pgs[name]

    def size(self, name: str) -> int:
        self.axis(name)
        return {"data": self.world, "model": self.model_size,
                "world": self.world * self.model_size}[name]

    def root(self, name: str) -> int:
        self.axis(name)
        return {"data": self.model_rank, "model": self.rank * self.model_size,
                "world": 0}[name]


def trim_to_multiple(n: int, k: int) -> int:
    """Largest n' ≤ n divisible by k."""
    return (n // k) * k


def padded_rows(n: int, world: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions (n + pad,) int64, weights (n + pad,) float32) with pad =
    (-n) mod world: 0..n-1, then wrap-around repeats of them with weight 0.
    np.resize cycles the positions, so pad > n (fewer rows than ranks)
    still gives exactly `pad` rows."""
    idx = np.arange(n, dtype=np.int64)
    pad = (-n) % world
    weights = np.ones(n + pad, np.float32)
    if pad:
        idx = np.concatenate([idx, np.resize(idx, pad)])
        weights[n:] = 0.0
    return idx, weights


def row_block(n_rows: int, group: DataGroup) -> slice:
    """The rank's contiguous block of n_rows: blocks of ⌈n_rows / world⌉ rows
    in data-rank order, the last ones shorter or empty (all equal when the
    data axis's size divides n_rows, as after padded_rows)."""
    per = -(-n_rows // group.world)
    return slice(min(group.rank * per, n_rows), min((group.rank + 1) * per, n_rows))


def shard_rows(group: DataGroup, *arrays):
    """The rank's block of each array's rows (row_block)."""
    out = tuple(a[row_block(a.shape[0], group)] for a in arrays)
    return out if len(out) != 1 else out[0]


def replicate(group: DataGroup | None, tensors) -> None:
    """Make every rank of the world hold global rank 0's values of
    `tensors`, in place: one broadcast of their concatenation."""
    from gppvae_tpu_torch.parallel.collectives import broadcast

    tensors = list(tensors)
    if group is None or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        broadcast(group, flat, axis="world")
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
