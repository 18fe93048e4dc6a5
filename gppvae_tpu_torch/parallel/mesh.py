"""The 1-D data mesh as torch.distributed ranks.

Counterpart of the 1-D half of gppvae_tpu/parallel/mesh.py (`make_mesh`,
`row_sharding`, `replicated`, `trim_to_multiple`, `shard_rows`). The JAX
package is one process over a mesh; here `world` processes each hold one
rank's contiguous block of the N-sized rows (images, Z, V, the Taylor rows)
and a replica of everything R-sized or parameter-sized. A DataGroup names the
rank, the world size and the rank's device (the ranks form torch.distributed's
default process group); every function that reduces over ranks takes one
explicitly, and `None` is the single-process path. `launch.run_ranks` /
`launch.RankPool` start the ranks.

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


@dataclasses.dataclass
class DataGroup:
    """One rank of the data axis. `counts` tallies the collectives this rank
    issued: (kind, bytes per call) → calls (see collectives.summary)."""

    rank: int
    world: int
    device: torch.device
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)


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
    in rank order, the last ones shorter or empty (all equal when the world
    size divides n_rows, as after padded_rows)."""
    per = -(-n_rows // group.world)
    return slice(min(group.rank * per, n_rows), min((group.rank + 1) * per, n_rows))


def shard_rows(group: DataGroup, *arrays):
    """The rank's block of each array's rows (row_block)."""
    out = tuple(a[row_block(a.shape[0], group)] for a in arrays)
    return out if len(out) != 1 else out[0]


def replicate(group: DataGroup | None, tensors) -> None:
    """Make every rank hold rank 0's values of `tensors`, in place: one
    broadcast of their concatenation."""
    from gppvae_tpu_torch.parallel.collectives import broadcast

    tensors = list(tensors)
    if group is None or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        broadcast(group, flat)
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
