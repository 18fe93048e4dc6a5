"""Minibatch plans that cover every row every epoch.

Counterpart of gppvae_tpu/train/batching.py: the last batch is padded by
wrap-around and masked with 0/1 weights, so every row appears once with
weight 1. Per-sample terms are summed over valid rows and divided by the
constant bs, which keeps the surrogate's epoch-gradient identity exact for
any N.
"""

from __future__ import annotations

import torch


def num_batches(num_train: int, bs: int) -> int:
    """ceil(num_train / bs)."""
    return -(-num_train // bs)


def epoch_batches(generator: torch.Generator, n: int, bs: int):
    """(batches (nb, bs) int64, weights (nb, bs) float32): a random
    permutation of 0..n-1 from `generator`, wrap-around padded."""
    if bs > n:
        raise ValueError(f"batch_size {bs} exceeds train set {n}")
    perm = torch.randperm(n, generator=generator)
    nb = num_batches(n, bs)
    pad = nb * bs - n
    weights = torch.ones(n, dtype=torch.float32)
    if pad:
        perm = torch.cat([perm, perm[:pad]])
        weights = torch.cat([weights, torch.zeros(pad, dtype=torch.float32)])
    return perm.reshape(nb, bs), weights.reshape(nb, bs)


def masked_means(weights: torch.Tensor, *terms: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Weighted per-valid-row means of (bs,) per-sample terms."""
    nvalid = torch.sum(weights)
    return tuple(torch.sum(weights * t) / nvalid for t in terms)
