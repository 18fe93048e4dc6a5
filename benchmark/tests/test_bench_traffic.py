"""The traffic: the same seed gives the same work, and every seed the same
sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import ROOT  # noqa: F401

from benchmark.harness import datagen, traffic, weights
from benchmark.reference import gppvae

MIX = {"kind": "serve", "objects_per_request": [1, 16],
       "check_share": 0.02, "max_checked": 40, "trace_requests": 200}
SEED = 2**31 + 12345


def _requests(seed, n=64, mix=MIX):
    r = traffic.Requests(mix, seed, num_objects=400, num_views=16)
    return [r.next() for _ in range(n)]


def test_requests_repeat_for_a_seed():
    a, b = _requests(SEED), _requests(SEED)
    for (d1, q1, c1), (d2, q2, c2) in zip(a, b):
        assert np.array_equal(d1, d2) and np.array_equal(q1, q2) and c1 == c2
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, _requests(SEED + 1)))


def test_every_seed_sends_every_size_once_a_block():
    for seed in (0, SEED, 7):
        reqs = _requests(seed, 32)
        for block in (reqs[:16], reqs[16:]):
            assert sorted(len(d) // 16 for d, _, _ in block) == list(range(1, 17))
        d, q, _ = reqs[0]
        assert len(set(d)) == len(d) // 16  # distinct objects
        assert np.array_equal(q, np.tile(np.arange(16), len(d) // 16))
    # the first of the largest requests is kept for the comparison
    assert any(c and len(d) == 256 for d, _, c in _requests(SEED, 16))


def test_warm_up_asks_every_size_the_traffic_sends_once():
    r = traffic.Requests(MIX, SEED, num_objects=400, num_views=16)
    warm = r.warm_sizes()
    assert [len(d) for d, _ in warm] == [16 * k for k in range(1, 17)]
    assert {len(d) for d, _, _ in _requests(SEED, 64)} == {len(d) for d, _ in warm}


def test_epoch_draws_repeat_and_cover_every_row():
    draws = traffic.epoch_draws(SEED, n=300, bs=128, zdim=4)
    b1, w1, e1 = draws(3)
    b2, w2, e2 = draws(3)
    assert torch.equal(b1, b2) and torch.equal(w1, w2) and torch.equal(e1, e2)
    assert b1.shape == (3, 128) and e1.shape == (3, 128, 4)
    assert sorted(b1.reshape(-1)[w1.reshape(-1) > 0].tolist()) == list(range(300))
    assert float(w1.sum()) == 300
    assert not torch.equal(draws(4)[0], b1)


def test_grids_and_weights_repeat_for_a_seed():
    data = {"kind": "faces", "num_objects": 6, "num_views": 3, "image_size": 16,
            "heldout_per_object": 1, "val_fraction": 0.05}
    g1, g2 = datagen.make_grid(data, SEED, "cpu"), datagen.make_grid(data, SEED, "cpu")
    assert torch.equal(g1["images"], g2["images"])
    assert np.array_equal(g1["train_idx"], g2["train_idx"])
    assert g1["images"].shape == (18, 16, 16, 3) and 0 <= float(g1["images"].min())
    model = {"zdim": 4, "enc_features": [8, 16], "dec_features": [16, 8],
             "obj_feature_dim": 3, "view_num_freqs": 1}
    train = {"init_v_sig": 1.0, "init_v_noise": 0.5}
    v1, p1 = weights.make(gppvae, model, train, g1, SEED, "cpu")
    v2, p2 = weights.make(gppvae, model, train, g2, SEED, "cpu")
    assert all(torch.equal(v1[k], v2[k]) for k in v1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_split_counts_match_the_paper_grids():
    for P, Q, n_train in ((400, 16, 5700), (542, 9, 4119)):
        for seed in (1, SEED):
            tr, val, ho = datagen.grid_split(P, Q, seed)
            assert (len(tr), len(ho)) == (n_train, P)
            assert len(np.unique(np.concatenate([tr, val, ho]))) == P * Q


@pytest.mark.parametrize("sent", [0, 5, 16])
def test_whole_blocks_ask_every_size_alike_for_every_seed(sent):
    """The card-only slice after the window: the rest of the current block
    is left unsent, then every size once a block, whatever the seed."""
    for seed in (0, SEED, 7):
        r = traffic.Requests(MIX, seed, num_objects=400, num_views=16)
        for _ in range(sent):
            r.next()
        got = r.blocks(2)
        assert len(got) == 32
        for block in (got[:16], got[16:]):
            assert sorted(len(d) // 16 for d, _ in block) == list(range(1, 17))
