"""The kernels' launch plans, and the NLL core's tensor-core arithmetic, on the CPU.

`plan_nll_core` and `plan_factor_prep` (gppvae_tpu_torch/ops) are plain
functions of the shape and the device's properties, given here as the
H100's numbers (132 SMs, 232,448 bytes of shared memory per block, clusters
of up to 16 CTAs, or 8 where the non-portable size is not allowed;
factor_prep's CTAs resident at once, FP_CAPACITY). The
kernels check the plans they are given; these tests check that the plans
cover what the kernels assume.

`emulate_nll_core` runs the kernel's arithmetic in numpy: the blocked
Cholesky in panels of 32 with step 1 in float32, and every product of steps
2 and 3 as the split-TF32 mma.sync does it (each operand rounded to TF32 by
cvt.rna on its float32 bits, x = hi + lo, lo·hi + hi·lo + hi·hi summed into
float32, eight consecutive k at a time). Held to float64 at R = 56, 232 and 560,
it shows on the CPU, before any card call, that 3xTF32 keeps the kernel's
bounds; `python tests/test_torch_nll_core_plan.py` prints the table PERF.md
quotes, one plain TF32 pass beside it.
"""

import importlib
import math

import numpy as np
import pytest
import torch
from _one_thread import one_thread  # noqa: F401

from gppvae_tpu_torch import ops
from gppvae_tpu_torch.ops import _build
from gppvae_tpu_torch.ops import nll_core as nc
from gppvae_tpu_torch.ops.factor_prep import _plan as fp_plan
from gppvae_tpu_torch.ops.factor_prep import plan_factor_prep

fp_module = importlib.import_module("gppvae_tpu_torch.ops.factor_prep")  # ops.factor_prep: the function
H100 = {"sms": 132, "smem_optin": 232448, "max_cluster": 16, "grid_per_sm": 1}
# factor_prep's CTAs resident at once per tile edge and cluster size
# (gppvae_factor_prep_capacity on an H100 80GB HBM3)
FP_CAPACITY = {bt: {8: 120, 4: 120, 2: 132, 1: 132} for bt in (32, 64, 128)}
H100_PORTABLE = {**H100, "max_cluster": 8}
# where plan_nll_core changes driver on an H100: the one CTA up to R = 128,
# the cluster up to 480, the grid above (PERF.md, the cut-overs)
CUTS = (128, 480)
# chip_smoke.py's factor_prep shapes and the workspace floats and tickets of
# the split-TF32 kernel's plan on an H100 (these once came from C size
# queries, gppvae_factor_prep_workspace / _tickets, before the plan moved to
# Python): a second pass only where N's chunks outnumber one cluster per tile
FACTOR_PREP_SIZES = {
    (5700, 56, 16): (61488, 8), (5701, 56, 16): (61488, 8), (6401, 256, 16): (276540, 24),
    (256, 2048, 8): (0, 0), (332, 232, 32): (0, 0), (5700, 560, 16): (0, 0),
    (2850, 56, 16): (30744, 8),
}


@pytest.mark.parametrize("props", [H100, H100_PORTABLE], ids=["cluster16", "cluster8"])
def test_every_shape_gets_one_driver_that_fits(props):
    optin = props["smem_optin"]
    for L in (1, 8, 16, 32):
        for R in range(1, 2101):
            p = nc.plan_nll_core(R, L, props)
            assert p.driver in nc.DRIVERS
            if p.driver == "grid":
                assert p.smem == 0 and p.scratch == R * nc.PLD + nc.NB * nc.DLD
                assert 1 <= p.ctas <= props["sms"]
                continue
            assert p.scratch == 0 and p.smem == nc.dist_smem(R, L, p.ctas) <= optin
            if p.driver == "cta":
                assert p.ctas == 1 and R <= nc.CTA_MAX_R
            else:
                assert 2 <= p.ctas <= min(props["max_cluster"], math.ceil(R / 32))


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_cut_overs_are_where_perf_md_says(max_cluster):
    props = {**H100, "max_cluster": max_cluster}
    cta_max, cluster_max = CUTS
    assert (nc.CTA_MAX_R, nc.CLUSTER_MAX_R) == CUTS
    for L in (1, 8, 16, 32):
        drivers = [nc.plan_nll_core(R, L, props).driver
                   for R in (cta_max, cta_max + 1, cluster_max, cluster_max + 1)]
        assert drivers == ["cta", "cluster", "cluster", "grid"], (L, drivers)
    # where a cluster's shared memory cannot hold the rows, the grid
    assert nc.plan_nll_core(300, 2000, props).driver == "grid"


def test_cluster_rows_cover_packed_m_exactly_once():
    for R in [*range(1, 300), *range(300, 2101, 13)]:
        nblk = math.ceil(R / 32)
        for C in range(2, 17):
            held = nc.row_blocks(R, C)
            blocks = sorted(b for h in held for b, _, _ in h)
            assert blocks == list(range(nblk))
            for h in held:  # each CTA's blocks back to back from 0, rows 16-byte aligned
                offset = 0
                for b, off, n in h:
                    assert off == offset and off % 4 == 0
                    assert n == sum(-(-(r + 1) // 4) * 4 for r in range(32 * b, min(32 * b + 32, R)))
                    offset += n
            assert sum(n for h in held for _, _, n in h) == nc.padded_prefix(R)
            assert max(len(h) for h in held) == math.ceil(nblk / C)


def test_factor_prep_plan_gives_the_c_queries_sizes():
    for (n, r, l), (ws, tickets) in FACTOR_PREP_SIZES.items():
        p = plan_factor_prep(n, r, l, FP_CAPACITY)
        assert (p.workspace, p.tickets) == (ws, tickets), (n, r, l)
        assert p.bt * p.row_tiles >= r and p.zw * p.z_tiles >= l
        assert p.chunks * p.rows_per_chunk >= n and p.chunks % p.cluster == 0
        assert p.ctas <= FP_CAPACITY[p.bt][p.cluster] or p.chunks == 1


@pytest.fixture
def fake_card(monkeypatch):
    """Device properties and cluster occupancy as an H100 gives them, and
    empty plan caches before and after."""
    monkeypatch.setattr(_build, "device_props", lambda index: H100)
    monkeypatch.setattr(fp_module, "_capacity", lambda index: FP_CAPACITY)
    fits = {"clusters": 1}
    monkeypatch.setattr(nc, "_clusters_fit", lambda index, C, smem: fits["clusters"])
    monkeypatch.setattr(nc.launch_nll_core, "cluster_refused", 0)
    nc._plan.cache_clear()
    fp_plan.cache_clear()
    yield fits
    nc._plan.cache_clear()
    fp_plan.cache_clear()


def test_plans_are_computed_once_per_device_and_shape(fake_card):
    for _ in range(3):
        assert nc._plan(0, 232, 32).driver == "cluster"
        assert nc._plan(0, 56, 16).driver == "cta"
        assert fp_plan(0, 5700, 56, 16) == plan_factor_prep(5700, 56, 16, FP_CAPACITY)
    nc._plan(1, 232, 32)
    assert (nc._plan.cache_info().misses, nc._plan.cache_info().hits) == (3, 4)
    assert (fp_plan.cache_info().misses, fp_plan.cache_info().hits) == (1, 2)


def test_a_cluster_the_device_cannot_hold_is_planned_as_the_grid(fake_card):
    fake_card["clusters"] = 0
    for _ in range(2):
        assert nc._plan(0, 232, 16) == nc.plan_nll_core(232, 16, H100, driver="grid")
    assert nc.launch_nll_core.cluster_refused == 1


def test_forced_plans_that_cannot_run_raise():
    with pytest.raises(ValueError, match="shared memory"):
        nc.plan_nll_core(2048, 8, H100, driver="cta")
    with pytest.raises(ValueError, match="no cluster of 32"):
        nc.plan_nll_core(2048, 8, H100, driver="cluster", cluster=32)
    with pytest.raises(ValueError, match="unknown driver"):
        nc.plan_nll_core(64, 8, H100, driver="warp")


def test_driver_counts_reset_and_survive_uncounted():
    nc.launch_nll_core.drivers["cluster"] = 3
    with ops.uncounted():
        nc.launch_nll_core.drivers["cluster"] += 5
    assert ops.driver_counts()["cluster"] == 3
    ops.reset_launch_counts()
    assert ops.driver_counts() == {"cta": 0, "cluster": 0, "grid": 0}


# ---- the kernel's arithmetic in numpy

F32, F64 = np.float32, np.float64


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits, on the float32 bits."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def mma(A: np.ndarray, B: np.ndarray, passes: int = 3) -> np.ndarray:
    """A (m, K) · B (K, n), K ≤ 32 (zero-padded to 32), as the kernel's
    mma.sync does it: 3 passes, lo·hi + hi·lo + hi·hi; 1 pass, hi·hi alone
    (plain TF32). Each mma sums its eight products (exact in float64, eight
    consecutive k) into the float32 accumulator with one rounding."""
    K = A.shape[1]
    A = np.pad(A.astype(F32), ((0, 0), (0, 32 - K)))
    B = np.pad(B.astype(F32), ((0, 32 - K), (0, 0)))
    Ah, Bh = tf32(A), tf32(B)
    Al, Bl = tf32(A - Ah), tf32(B - Bh)
    pairs = [(Al, Bh), (Ah, Bl), (Ah, Bh)] if passes == 3 else [(Ah, Bh)]
    acc = np.zeros((A.shape[0], B.shape[1]), F32)
    for k0 in range(0, 32, 8):
        for a, b in pairs:
            acc = (acc.astype(F64) + a[:, k0:k0 + 8].astype(F64) @ b[k0:k0 + 8].astype(F64)).astype(F32)
    return acc


def factor_and_invert(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Step 1 in float32: the Cholesky factor of the lower triangle of A
    (right-looking, 1/√pivot) and its inverse by substitution."""
    n = A.shape[0]
    Lk = np.tril(A).astype(F32)
    inv = np.zeros(n, F32)
    for j in range(n):
        rs = F32(1) / np.sqrt(Lk[j, j], dtype=F32)
        inv[j] = rs
        Lk[j, j] = Lk[j, j] * rs
        Lk[j + 1:, j] *= rs
        Lk[j + 1:, j + 1:] -= np.tril(np.outer(Lk[j + 1:, j], Lk[j + 1:, j])).astype(F32)
    D = np.eye(n, dtype=F32)
    for m in range(n):
        D[m] *= inv[m]
        D[m + 1:] -= np.outer(Lk[m + 1:, m], D[m]).astype(F32)
    return Lk, np.tril(D)


def emulate_nll_core(G, UtZ, zn, vn, n_rows, l_dims, passes: int = 3):
    """(nll, X, W) by the kernel's algorithm: panels of 32, [W | X] carried
    along, X in M's finished columns, steps 2-3 through `mma`."""
    R = G.shape[0]
    M = np.tril(np.eye(R, dtype=F32) + (G / F32(vn)).astype(F32))
    W = UtZ.astype(F32).copy()
    lsum = F32(0)
    for c0 in range(0, R, 32):
        s = min(c0 + 32, R)
        Lk, D = factor_and_invert(M[c0:s, c0:s])
        lsum = F32(lsum + np.sum(np.log(np.diag(Lk)), dtype=F32))
        if s < R:
            P = mma(M[s:, c0:s], D.T, passes)
            M[s:, c0:s] = -mma(P, D, passes)
        W[c0:s] = mma(D, W[c0:s], passes)
        if c0:
            M[c0:s, :c0] = mma(D, M[c0:s, :c0], passes)
        M[c0:s, c0:s] = D
        if s < R:
            M[s:, s:] -= np.tril(mma(P, P.T, passes))
            W[s:] -= mma(P, W[c0:s], passes)
            if c0:
                M[s:, :c0] -= mma(P, M[c0:s, :c0], passes)
    wsq = np.sum(W * W, dtype=F32)
    quad = (F32(zn) - wsq / F32(vn)) / F32(vn)
    nll = F32(0.5) * (F32(l_dims) * (F32(n_rows) * np.log(F32(vn)) + F32(2) * lsum) + quad
                      + F32(n_rows * l_dims * math.log(2 * math.pi)))
    return float(nll), np.tril(M), W


def core_inputs(r: int, l: int, n: int = 6400, seed: int = 0):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, r)) / math.sqrt(r)
    Z = rng.standard_normal((n, l))
    return (U.T @ U).astype(F32), (U.T @ Z).astype(F32), F32(np.sum(Z * Z)), F32(0.37)


def distances(r: int, l: int, passes: int = 3) -> dict:
    """The emulation's and the float32 plain version's distances from float64:
    the value (relative) and X, W (max abs)."""
    G, UtZ, zn, vn = core_inputs(r, l)
    n = 6400
    ref = ops.nll_core_torch(*(torch.from_numpy(np.asarray(a, F64)) for a in (G, UtZ, zn, vn)),
                             n, l)
    f32 = ops.nll_core_torch(*(torch.from_numpy(np.asarray(a, F32)) for a in (G, UtZ, zn, vn)),
                             n, l)
    emu = emulate_nll_core(G, UtZ, zn, vn, n, l, passes)

    def xw(nll, X, W):
        return max(float(np.max(np.abs(np.asarray(X, F64) - ref[1].numpy()))),
                   float(np.max(np.abs(np.asarray(W, F64) - ref[2].numpy()))))

    value = float(ref[0])
    return {"R": r, "L": l, "passes": passes,
            "value_rel": abs(emu[0] - value) / abs(value), "xw": xw(*emu),
            "plain_f32_value_rel": abs(float(f32[0]) - value) / abs(value),
            "plain_f32_xw": xw(*(t.numpy() for t in f32))}


@pytest.mark.parametrize("r,l", [(56, 16), (232, 32), (560, 16)])
def test_split_tf32_arithmetic_keeps_the_bounds(r, l):
    """The value within 1e-5 of float64 (the kernel's bound against the
    plain version); X and W within twice the float32 plain version's own
    distance from float64: the two round in different places (rsqrt pivots,
    products summed eight at a time), but neither may be much worse."""
    d = distances(r, l)
    assert d["value_rel"] <= 1e-5, d
    assert d["xw"] <= 2 * d["plain_f32_xw"], d


def test_one_plain_tf32_pass_would_not():
    """hi·hi alone (one TF32 pass, ~3 decimal digits) leaves X and W about a
    thousand times farther from float64 than float32 is (PERF.md)."""
    d = distances(232, 32, passes=1)
    assert d["xw"] > 100 * d["plain_f32_xw"], d


def test_tf32_rounds_to_nearest_ties_away():
    x = np.array([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0], F32)
    np.testing.assert_array_equal(tf32(x), np.array([1 + 2**-10, 1 + 2 * 2**-10,
                                                     -(1 + 2**-10), 1.0, 3.0], F32))
    y = np.random.default_rng(1).standard_normal(1000).astype(F32)
    hi = tf32(y)
    assert np.all(np.abs(y - hi) <= np.abs(y) * 2.0**-11)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)


if __name__ == "__main__":
    for r, l in [(56, 16), (232, 32), (560, 16)]:
        for passes in (3, 1):
            print(distances(r, l, passes))
