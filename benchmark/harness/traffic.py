"""The one generator of every traffic mix: it reads a mix's parameters
(traffic/<name>.json) and the seed, and gives the work the program gets.

Training mixes (`"kind": "train"`): epoch e's plan and noise, drawn from
(seed, e) alone, so the reference draws the same: a permutation of the
training rows in batches of the configuration's batch size, the last batch
padded by wrap-around with weight-0 rows, and one standard-normal ε per row
and latent dimension.

Serving mixes (`"kind": "serve"`): one client in a closed loop (the next
request when the reply is in) asks for every view of k distinct objects, k
uniform on `objects_per_request` = [lo, hi]. Each block of hi - lo + 1
requests asks for every k once, in an order drawn from the seed, so every
seed sends the same sizes. A share `check_share` of the requests, drawn from
the seed, and the first of the largest, are kept for the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.datagen import sub_seed


def epoch_draws(seed: int, n: int, bs: int, zdim: int):
    """draws(epoch) → (batches (nb, bs) int64, weights (nb, bs) float32,
    ε (nb, bs, zdim) float32), CPU tensors."""
    nb = -(-n // bs)

    def draws(epoch: int):
        g = torch.Generator()
        g.manual_seed(sub_seed(seed, 1000 + epoch))
        perm = torch.randperm(n, generator=g)
        weights = torch.ones(nb * bs)
        pad = nb * bs - n
        if pad:
            perm = torch.cat([perm, perm[:pad]])
            weights[n:] = 0.0
        eps = torch.randn(nb, bs, zdim, generator=g)
        return perm.reshape(nb, bs), weights.reshape(nb, bs), eps

    return draws


class Requests:
    """The requests of a serving mix, in order, without end: each
    (d, q, checked), d and q int64 numpy rows."""

    def __init__(self, mix: dict, seed: int, num_objects: int, num_views: int):
        lo, hi = mix["objects_per_request"]
        self.sizes = np.arange(lo, hi + 1)
        self.P, self.Q = num_objects, num_views
        self.share = mix["check_share"]
        self.rng = np.random.default_rng(sub_seed(seed, 5))
        self.block: list = []
        self.largest_kept = False

    def next(self):
        if not self.block:
            self.block = list(self.rng.permutation(self.sizes))
        k = int(self.block.pop())
        objects = self.rng.choice(self.P, size=k, replace=False)
        d = np.repeat(objects, self.Q).astype(np.int64)
        q = np.tile(np.arange(self.Q), k).astype(np.int64)
        checked = bool(self.rng.random() < self.share)
        if k == self.sizes[-1] and not self.largest_kept:
            checked = self.largest_kept = True
        return d, q, checked

    def blocks(self, n: int) -> list:
        """The (d, q) of the next n whole blocks, the rest of the current
        block left unsent: every seed the same sizes, in its own order."""
        self.block = []
        return [self.next()[:2] for _ in range(n * len(self.sizes))]

    def warm_sizes(self):
        """One request of every size, for the set-up's warm-up."""
        return [(np.repeat(np.arange(k) % self.P, self.Q).astype(np.int64),
                 np.tile(np.arange(self.Q), k).astype(np.int64)) for k in self.sizes]
