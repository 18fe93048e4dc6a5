"""Minibatch plans that cover every row every epoch, and the epoch's draws.

Counterpart of gppvae_tpu/train/batching.py: the last batch is padded by
wrap-around and masked with 0/1 weights, so every row appears once with
weight 1. Per-sample terms are summed over valid rows and divided by the
constant bs, which keeps the surrogate's epoch-gradient identity exact for
any N.

The draws are the JAX trainers' (utils/prng.py): epoch e's key is
fold_in(run_key, e), its plan permutation(epoch_key, n), and step s's ε
normal(split(fold_in(epoch_key, 1), nb)[s], (bs, zdim)). They depend on
the run key and the epoch alone, so a resumed run draws what the
uninterrupted one did. One epoch's draws at the slice's shapes (5,700
rows, 45 steps of 128 × 16) take a few milliseconds of host time; they
are drawn at the epoch's start, on the training loop's thread (drawn one
epoch ahead in a worker thread, they cost the loop as much through the
shared interpreter and cores).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gppvae_tpu_torch.utils import prng


def num_batches(num_train: int, bs: int) -> int:
    """ceil(num_train / bs)."""
    return -(-num_train // bs)


def epoch_batches(key: np.ndarray, n: int, bs: int):
    """(batches (nb, bs) int64, weights (nb, bs) float32): the permutation
    of 0..n-1 that jax.random.permutation(key, n) gives, wrap-around
    padded."""
    if bs > n:
        raise ValueError(f"batch_size {bs} exceeds train set {n}")
    perm = prng.permutation(key, n).astype(np.int64)
    nb = num_batches(n, bs)
    pad = nb * bs - n
    weights = np.ones(n, np.float32)
    if pad:
        perm = np.concatenate([perm, perm[:pad]])
        weights = np.concatenate([weights, np.zeros(pad, np.float32)])
    return torch.from_numpy(perm.reshape(nb, bs)), torch.from_numpy(weights.reshape(nb, bs))


def make_draws(run_key: np.ndarray, num_train: int, bs: int, zdim: int) -> Callable:
    """draws(epoch) → (batches, weights, ε (nb, bs, zdim)) of the JAX
    trainers' epoch (train_gppvae.py:507-508, train_cvae.py)."""
    nb = num_batches(num_train, bs)

    def draws(epoch: int):
        key = prng.fold_in(run_key, epoch)
        eps = prng.normal(prng.split(prng.fold_in(key, 1), nb), (bs, zdim))  # all steps at once
        return (*epoch_batches(key, num_train, bs), torch.from_numpy(eps))

    return draws


def masked_means(weights: torch.Tensor, *terms: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Weighted per-valid-row means of (bs,) per-sample terms."""
    nvalid = torch.sum(weights)
    return tuple(torch.sum(weights * t) / nvalid for t in terms)
