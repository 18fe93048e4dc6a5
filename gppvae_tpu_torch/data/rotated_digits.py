"""Rotated-digits dataset builder (the rotated-MNIST experiment family).

The port's copy of gppvae_tpu/data/rotated_digits.py.

Reference counterpart: the fork's rotated-MNIST generator (SURVEY.md §2.1,
§3.5): take P instances of one digit class, rotate each through Q evenly
spaced angles in [0, 2π), hold out (instance, angle) cells for out-of-sample
evaluation. Object id = digit instance, view id = rotation angle.

Pluggable pixel sources (this environment has no network and no bundled
MNIST, SURVEY.md §6 note):

  * 'mnist:<dir>'  — real MNIST idx files on disk (the reference's source)
  * 'sklearn'      — scikit-learn's bundled 8×8 handwritten digits, upscaled
                     (real data, always available offline)
  * 'synthetic'    — procedural glyph renderer, deterministic per seed, any
                     number of instances (benchmark-shape fidelity at N=6400)

Images are padded/resized to `image_size`² (default 32 — MXU-friendly and
keeps the full digit inside the frame under rotation).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from gppvae_tpu_torch.data.dataset import GridDataset, make_grid_split
from gppvae_tpu_torch.data.transforms import pad_to, resize_bilinear, rotate_bilinear


def synthetic_digit3(num_instances: int, seed: int, hw: int = 28) -> np.ndarray:
    """Procedurally render `num_instances` distinct '3'-like glyphs.

    Two left-opening circular arcs stacked vertically, with per-instance
    radius, stroke width, jitter, shear and intensity — enough intra-class
    variation for a meaningful object kernel, fully deterministic in `seed`.
    Returns (num_instances, hw, hw) float32 in [0, 1].
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(hw, dtype=np.float32),
                         np.arange(hw, dtype=np.float32), indexing="ij")
    out = np.zeros((num_instances, hw, hw), dtype=np.float32)
    for i in range(num_instances):
        r = hw * rng.uniform(0.14, 0.19)
        width = rng.uniform(0.9, 1.8)
        shear = rng.uniform(-0.15, 0.15)
        cx = hw / 2 + rng.uniform(-1.5, 1.5) + r * 0.25
        cy = hw / 2 + rng.uniform(-1.0, 1.0)
        amp = rng.uniform(0.75, 1.0)
        span = rng.uniform(2.0, 2.5)  # angular half-span of each arc (rad)
        img = np.zeros((hw, hw), dtype=np.float32)
        for sgn in (-1.0, 1.0):  # upper / lower arc
            acx, acy = cx + shear * sgn * r, cy + sgn * r * 0.95
            dx, dy = xx - acx, yy - acy
            dist = np.abs(np.sqrt(dx * dx + dy * dy) - r)
            phi = np.arctan2(sgn * dy, dx)  # mirror so both open left
            in_arc = np.abs(phi) < span / 2
            img += np.where(in_arc, np.exp(-((dist / width) ** 2)), 0.0)
        out[i] = np.clip(amp * img, 0.0, 1.0)
    return out


def _sklearn_digits(digit: int, num_instances: int) -> np.ndarray:
    from sklearn.datasets import load_digits

    data = load_digits()
    imgs = data.images[data.target == digit].astype(np.float32) / 16.0
    if len(imgs) < num_instances:
        reps = -(-num_instances // len(imgs))
        imgs = np.tile(imgs, (reps, 1, 1))
    return resize_bilinear(imgs[:num_instances], (28, 28))


def _mnist_digits(dirname: str, digit: int, num_instances: int) -> np.ndarray:
    from gppvae_tpu_torch.data.mnist_idx import load_mnist_train

    images, labels = load_mnist_train(dirname)
    imgs = images[labels == digit]
    if len(imgs) < num_instances:
        raise ValueError(f"only {len(imgs)} instances of digit {digit} in MNIST")
    return imgs[:num_instances]


def build_rotated_digits(
    source: str = "synthetic",
    *,
    digit: int = 3,
    num_objects: int = 400,
    num_views: int = 16,
    image_size: int = 32,
    heldout_per_object: int = 1,
    val_fraction: float = 0.05,
    seed: int = 0,
    cache_dir: str | None = None,
) -> GridDataset:
    """Build (or load cached) the P×Q rotated-digits grid dataset."""
    if cache_dir:
        tag = f"{source}-{digit}-{num_objects}-{num_views}-{image_size}-{heldout_per_object}-{val_fraction}-{seed}"
        cache = os.path.join(
            cache_dir, f"rotdig-{hashlib.sha1(tag.encode()).hexdigest()[:12]}.npz"
        )
        if os.path.exists(cache):
            return GridDataset.load_npz(cache)

    if source == "synthetic":
        base = synthetic_digit3(num_objects, seed=seed)
    elif source == "sklearn":
        base = _sklearn_digits(digit, num_objects)
    elif source.startswith("mnist:"):
        base = _mnist_digits(source.split(":", 1)[1], digit, num_objects)
    else:
        raise ValueError(
            f"unknown source {source!r}; want 'synthetic', 'sklearn', or 'mnist:<dir>'"
        )

    P, Q = num_objects, num_views
    if image_size >= base.shape[1]:
        base = pad_to(base, (image_size, image_size))  # (P, S, S)
    else:
        # smaller than the source digits (e.g. 16² quick configs):
        # zero-pad can't shrink — downsample instead
        base = resize_bilinear(base, (image_size, image_size))
    angles = np.linspace(0.0, 2 * np.pi, Q, endpoint=False).astype(np.float32)

    # rotate every instance through every angle: grid row n = d·Q + q
    images = np.empty((P * Q, image_size, image_size, 1), dtype=np.float32)
    for q, theta in enumerate(angles):
        rot = rotate_bilinear(base, np.full(P, theta, np.float32))
        images[q::Q, :, :, 0] = rot  # rows d·Q + q for all d
    np.clip(images, 0.0, 1.0, out=images)

    object_ids = np.repeat(np.arange(P, dtype=np.int32), Q)
    view_ids = np.tile(np.arange(Q, dtype=np.int32), P)
    train_idx, val_idx, heldout_idx = make_grid_split(
        P, Q, heldout_per_object=heldout_per_object,
        val_fraction=val_fraction, seed=seed,
    )
    ds = GridDataset(
        images=images,
        object_ids=object_ids,
        view_ids=view_ids,
        view_aux=angles[:, None],
        train_idx=train_idx,
        val_idx=val_idx,
        heldout_idx=heldout_idx,
        name=f"rotated-digits-{source.split(':')[0]}",
    )
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        ds.save_npz(cache)
    return ds
