"""The grid-dataset contract shared by every experiment.

The port's copy of gppvae_tpu/data/dataset.py.

GPPVAE data is a (partially observed) P-objects × Q-views grid of images
(SURVEY.md §3.5): each sample carries an object id d(n) and a view id q(n).
Out-of-sample evaluation predicts images for *held-out* grid cells from
(object, view) alone via GP-predictive latents (SURVEY.md §3.4), so the held
out cells' images ride along in the dataset but never enter training.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridDataset:
    """A complete object×view grid with a train/val/heldout row partition.

    images:     (N, H, W, C) float32 in [0, 1], N = P·Q, row-major over the
                (object, view) grid: n = d·Q + q.
    object_ids: (N,) int32 in [0, P)
    view_ids:   (N,) int32 in [0, Q)
    view_aux:   (Q, A) float32 per-view auxiliary info (e.g. rotation angle
                as a (Q, 1) column) — feeds fixed view-feature maps.
    train_idx / val_idx / heldout_idx: disjoint int32 index arrays into rows.
                heldout rows are the out-of-sample (object, view) cells.
    """

    images: np.ndarray
    object_ids: np.ndarray
    view_ids: np.ndarray
    view_aux: np.ndarray
    train_idx: np.ndarray
    val_idx: np.ndarray
    heldout_idx: np.ndarray
    name: str = "grid"
    # whether scalar view_aux wraps around (rotation angles → periodic
    # Fourier view features) or is linear (pose positions → polynomial)
    periodic_views: bool = True

    @property
    def num_objects(self) -> int:
        return int(self.object_ids.max()) + 1

    @property
    def num_views(self) -> int:
        return int(self.view_ids.max()) + 1

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return tuple(self.images.shape[1:])  # type: ignore[return-value]

    def __post_init__(self):
        n = len(self.images)
        assert len(self.object_ids) == len(self.view_ids) == n
        parts = np.concatenate([self.train_idx, self.val_idx, self.heldout_idx])
        assert len(np.unique(parts)) == len(parts), "splits must be disjoint"

    def save_npz(self, path) -> None:
        np.savez_compressed(path, **dataclasses.asdict(self))

    @staticmethod
    def load_npz(path) -> "GridDataset":
        def conv(k, v):
            if k == "name":
                return str(v)
            if k == "periodic_views":
                return bool(v)
            return v

        with np.load(path, allow_pickle=False) as f:
            return GridDataset(**{k: conv(k, f[k]) for k in f.files})


def make_grid_split(
    P: int,
    Q: int,
    *,
    heldout_per_object: int = 1,
    val_fraction: float = 0.05,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition the P×Q grid rows: per object, hold out `heldout_per_object`
    random views entirely (out-of-sample cells); of the rest, carve a random
    val fraction; remainder trains. Deterministic in `seed`.
    """
    rng = np.random.default_rng(seed)
    if not 0 <= heldout_per_object < Q:
        raise ValueError(
            f"heldout_per_object={heldout_per_object} must leave at least "
            f"one training view per object (Q={Q})"
        )
    n = P * Q
    heldout = np.zeros(n, dtype=bool)
    for d in range(P):
        views = rng.choice(Q, size=heldout_per_object, replace=False)
        heldout[d * Q + views] = True
    rest = np.flatnonzero(~heldout)
    rng.shuffle(rest)
    n_val = int(round(val_fraction * len(rest)))
    val = np.zeros(n, dtype=bool)
    val[rest[:n_val]] = True
    # the guard above promises ≥1 TRAINING view per object, but random val
    # carving could consume an object's last non-heldout view (e.g. Q=2,
    # heldout_per_object=1): that object's X row would train with zero
    # anchoring observations and its heldout prediction silently degrades.
    # Demote one val row back to train for any such object.
    for d in range(P):
        rows = np.arange(d * Q, (d + 1) * Q)
        trainable = ~heldout[rows]
        if trainable.any() and val[rows[trainable]].all():
            val[rows[trainable][0]] = False
    val_idx = np.sort(np.flatnonzero(val)).astype(np.int32)
    train_idx = np.sort(np.flatnonzero(~heldout & ~val)).astype(np.int32)
    heldout_idx = np.flatnonzero(heldout).astype(np.int32)
    return train_idx, val_idx, heldout_idx
