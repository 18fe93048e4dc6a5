"""factor_prep's launch plan, and its split-TF32 arithmetic, on the CPU.

`plan_factor_prep` (gppvae_tpu_torch/ops/factor_prep.py) is a plain function
of the shape, the pointers' alignment and how many CTAs of each kernel the
card holds at once (`capacity`, given here as an H100 80GB HBM3
reported it: clusters of 8 and 4 fit 120 CTAs, of 2 and 1 all 132 SMs).
The kernel (csrc/factor_prep.cu) checks the plan's integers; these tests
check that the plan covers what the kernel assumes, with a mirror of the
kernel's tile order and warp groups (`tile_of`, `warp_groups`).

`emulate_factor_prep` runs the kernel's arithmetic in numpy: every operand
split as x = hi + lo in TF32 (the rounding of `tf32`, which the kernel's
split_rn computes with two integer operations), lo·hi + hi·lo + hi·hi of
eight rows summed into a fresh float32 accumulator, rounded toward zero as
the tensor cores round (`toward_zero`), each such step added to the running
sum rounded to nearest, the steps dealt to the warp groups, and the partial
sums added in the kernel's fixed order (warp groups, the CTAs of a cluster
by rank, the clusters). Held to float64 at the
main path's shape and at R 256, it shows on the CPU that split TF32 keeps
float32's accuracy and one TF32 pass does not; `PYTHONPATH=.:tests python
tests/test_torch_factor_prep_plan.py` prints the distances PERF.md quotes.
"""

import importlib
import math

import numpy as np
import pytest
import torch
from _one_thread import one_thread  # noqa: F401
from test_torch_nll_core_plan import FP_CAPACITY as CAPACITY
from test_torch_nll_core_plan import H100, tf32

fp = importlib.import_module("gppvae_tpu_torch.ops.factor_prep")  # ops.factor_prep: the function

F32, F64 = np.float32, np.float64
# chip_smoke.py's factor_prep shapes, and shapes with odd R and L, short N
SHAPES = [(5700, 56, 16), (5701, 56, 16), (6401, 256, 16), (256, 2048, 8), (332, 232, 32),
          (5700, 560, 16), (2850, 56, 16), (262144, 256, 16), (262144, 512, 16),
          (1, 3, 1), (127, 64, 64), (5700, 57, 16), (5700, 130, 16), (5700, 56, 1),
          (20, 56, 16), (777, 200, 70), (100, 3, 5), (3000, 300, 40), (64, 32, 8)]


def _cdiv(a, b):
    return -(-a // b)


def tile_of(plan, tile):
    """csrc decode(): (kind, r0, c0, z0) of tile `tile` in row-tile order."""
    rt = 0
    while tile >= rt + plan.z_tiles:
        tile -= rt + plan.z_tiles
        rt += 1
    r0 = rt * plan.bt
    if tile < rt:
        return "off", r0, tile * plan.bt, 0
    return ("diag" if tile == rt else "z"), r0, r0, (tile - rt) * plan.zw


def warp_groups(kind, bt, vr, nz):
    """csrc group_at() for every warp slot: (column block c, row blocks);
    column blocks of G first (c < ng), then Z's."""
    rb, wg = bt // 32, bt // 16
    blocks = vr * rb if kind == "off" else (vr * (vr + 1) // 2 if kind == "diag" else 0) + vr * nz
    pair = blocks > wg
    ng = 0 if kind == "z" else rb if kind == "off" else vr
    out = []
    for c in range(ng + (0 if kind == "off" else nz)):
        first = c if c < ng and kind == "diag" else 0
        rows = vr - first
        for s in range(_cdiv(rows, 2) if pair else rows):
            i0 = first + (2 * s if pair else s)
            out.append((c, ng, sorted({i0, min(i0 + 1, vr - 1) if pair else i0})))
    assert len(out) <= wg, (kind, bt, vr, nz)
    return out


def stores(plan, R, L):
    """How many times the kernel's tiles, warp groups and store rule write
    each element of [G | UtZ] (csrc store())."""
    count = np.zeros((R, R + L), np.int64)
    for tile in range(plan.tiles):
        kind, r0, c0, z0 = tile_of(plan, tile)
        vr = min(plan.bt // 32, _cdiv(R - r0, 32))
        zwv = 0 if kind == "off" else min(plan.zw, L - z0)
        for c, ng, rows in warp_groups(kind, plan.bt, vr, _cdiv(zwv, 32)):
            for i in rows:
                gr = r0 + 32 * i + np.arange(32)[:, None]
                if c < ng:
                    gc = c0 + 32 * c + np.arange(32)[None, :]
                    keep = (gr < R) & (gc <= gr)
                    r_, c_ = np.broadcast_arrays(gr, gc)
                    np.add.at(count, (r_[keep], c_[keep]), 1)
                    mirror = keep & (gc < gr)
                    np.add.at(count, (c_[mirror], r_[mirror]), 1)
                else:
                    zc = z0 + 32 * (c - ng) + np.arange(32)[None, :]
                    keep = (gr < R) & (zc < min(L, z0 + plan.zw))
                    r_, z_ = np.broadcast_arrays(gr, zc)
                    np.add.at(count, (r_[keep], R + z_[keep]), 1)
    return count


@pytest.mark.parametrize("n,r,l", SHAPES)
def test_plan_covers_r_rl_and_n_exactly(n, r, l):
    """Every element of G (both triangles, through the mirror) and of UᵀZ
    is stored once, and N's chunks cover its rows."""
    p = fp.plan_factor_prep(n, r, l, CAPACITY)
    assert p.row_tiles == _cdiv(r, p.bt) and p.z_tiles == _cdiv(l, p.zw) and p.zw <= l
    assert p.tiles == p.row_tiles * (p.row_tiles - 1) // 2 + p.row_tiles * p.z_tiles
    assert np.all(stores(p, r, l) == 1)
    assert p.chunks % p.cluster == 0 and p.chunks * p.rows_per_chunk >= n


def test_unaligned_or_odd_shapes_take_the_4_byte_copies():
    assert fp.plan_factor_prep(5700, 56, 16, CAPACITY).copy == "tma"
    for shape, aligned in [((5700, 56, 16), False), ((5700, 57, 16), True),
                           ((5700, 56, 1), True), ((1, 3, 1), True), ((5700, 130, 18), True)]:
        assert fp.plan_factor_prep(*shape, CAPACITY, aligned).copy == "cp4", shape
    assert set(fp.COPIES) == {"cp4", "tma"}


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 5700, 262144])
def test_plan_uses_at_most_the_ctas_it_claims(n):
    """One wave: tiles · chunks within what the card holds in clusters of
    that size (unless the tiles alone exceed it), one chunk per 32 rows at
    most, and the shared memory within the opt-in."""
    for r in (1, 3, 32, 33, 56, 64, 65, 128, 129, 232, 256, 512, 560, 1000, 2048):
        for l in (1, 8, 16, 32, 64):
            p = fp.plan_factor_prep(n, r, l, CAPACITY)
            assert p.ctas <= CAPACITY[p.bt][p.cluster] or p.chunks == 1, (n, r, l, p)
            assert p.chunks <= max(1, _cdiv(n, fp.MIN_ROWS_PER_CHUNK)) or p.chunks == p.cluster
            assert p.smem <= H100["smem_optin"] and p.cluster in fp.CLUSTERS
            assert p.workspace == (0 if p.chunks == p.cluster else
                                   p.tiles * (p.chunks // p.cluster) * fp.partial_floats(p.bt, p.zw))


def test_forced_plans():
    p = fp.make_plan(5700, 56, 16, 64, 8, 16)
    assert (p.bt, p.cluster, p.chunks, p.rows_per_chunk, p.tickets) == (64, 8, 16, 357, 8)
    assert fp.make_plan(256, 2048, 8, 64, 1, 1).tiles == 32 * 31 // 2 + 32
    assert fp.make_plan(5700, 56, 16, 64, 1, 1, aligned=False).copy == "cp4"
    for shape in SHAPES:  # the chosen plan is make_plan's of its own choices
        p = fp.plan_factor_prep(*shape, CAPACITY)
        assert p == fp.make_plan(*shape, p.bt, p.cluster, p.chunks), shape
    with pytest.raises(ValueError, match="tile edge"):
        fp.make_plan(5700, 56, 16, 96, 1, 1)
    with pytest.raises(ValueError, match="clusters of 8"):
        fp.make_plan(5700, 56, 16, 64, 8, 12)
    with pytest.raises(ValueError, match="clusters of 3"):
        fp.make_plan(5700, 56, 16, 64, 3, 3)


# ---- the kernel's arithmetic in numpy


def emulate_factor_prep(U, Z, plan, passes: int = 3, per_step: bool = True):
    """(G, UtZ, zn) by the kernel's arithmetic (see the module's note);
    per_step False: every step's passes straight into the running
    accumulator, rounded toward zero each time."""
    N, R = U.shape
    C, K, rpc = plan.cluster, plan.chunks // plan.cluster, plan.rows_per_chunk
    kg = 8 // (plan.bt // 16)  # warp groups over a stage's 8-row steps
    steps = _cdiv(rpc, 32) * 4
    X = np.zeros((plan.chunks * rpc, R + Z.shape[1]), F32)
    X[:N] = np.concatenate([U, Z], 1)
    X = np.pad(X.reshape(plan.chunks, rpc, -1), ((0, 0), (0, 8 * steps - rpc), (0, 0)))
    hi = tf32(X).reshape(X.shape)
    lo = tf32(X - hi).reshape(X.shape)
    pairs = [(lo, hi), (hi, lo), (hi, hi)] if passes == 3 else [(hi, hi)]
    acc = np.zeros((kg, plan.chunks, R, X.shape[2]), F32)
    for s in range(steps):
        rows = slice(8 * s, 8 * s + 8)
        step = np.zeros(acc.shape[1:], F32) if per_step else acc[s % kg]
        for a, b in pairs:
            prod = np.matmul(a[:, rows, :R].transpose(0, 2, 1).astype(F64), b[:, rows].astype(F64))
            step = toward_zero(step + prod)
        acc[s % kg] = (acc[s % kg] + step).astype(F32) if per_step else step
    zz = (X[:, :, R:].astype(F64) ** 2).astype(F32)
    part = np.concatenate([_in_order(acc), np.zeros((plan.chunks, R, 1), F32)], 2)
    part[:, 0, -1] = zz.reshape(plan.chunks, -1).sum(axis=1, dtype=F32)  # ‖Z‖² per chunk
    out = _in_order(_in_order(part.reshape(K, C, R, -1).transpose(1, 0, 2, 3)))
    G = np.tril(out[:, :R])
    return G + np.tril(G, -1).T, out[:, R:-1], out[0, -1]


def toward_zero(x):
    """float64 → float32 rounded toward zero, as the tensor cores' float32
    accumulator rounds an mma's sum."""
    y = x.astype(F32)
    over = np.abs(y.astype(F64)) > np.abs(x)
    y[over] = np.nextafter(y[over], F32(0))
    return y


def _in_order(a):
    """a[0] + a[1] + … in float32, left to right."""
    s = a[0].copy()
    for x in a[1:]:
        s = (s + x).astype(F32)
    return s


def distances(n, r, l, passes: int = 3, per_step: bool = True, **force) -> dict:
    """The emulation's and the float32 plain version's max abs error from
    float64, over max |·|, per output (`force`: make_plan's cluster and
    chunks in place of plan_factor_prep's)."""
    rng = np.random.default_rng(0)
    U = (rng.standard_normal((n, r)) / math.sqrt(r)).astype(F32)
    Z = rng.standard_normal((n, l)).astype(F32)
    ref = [np.asarray(t, F64) for t in fp.factor_prep_torch(torch.from_numpy(U.astype(F64)),
                                                            torch.from_numpy(Z.astype(F64)))]
    plain = [t.numpy() for t in fp.factor_prep_torch(torch.from_numpy(U), torch.from_numpy(Z))]
    plan = (fp.make_plan(n, r, l, fp.tile_edge(r), **force) if force
            else fp.plan_factor_prep(n, r, l, CAPACITY))
    emu = emulate_factor_prep(U, Z, plan, passes, per_step)

    def rel(got):
        return [float(np.max(np.abs(np.asarray(g, F64) - w)) / np.max(np.abs(w)))
                for g, w in zip(got, ref)]

    return {"shape": [n, r, l], "passes": passes, "emulated": rel(emu), "plain_f32": rel(plain)}


@pytest.mark.parametrize("n,r,l", [(5700, 56, 16), (1500, 232, 32)])
def test_split_tf32_arithmetic_keeps_the_bound(n, r, l):
    """G, UᵀZ and ‖Z‖² each within 1e-5 of float64 (FACTOR_PREP_REL_BOUND);
    the products G and UᵀZ within twice the float32 plain version's own
    distance (‖Z‖² is a float32 sum on the CUDA cores either way, in
    another order than torch.sum's)."""
    d = distances(n, r, l)
    assert max(d["emulated"]) <= 1e-5, d
    for e, p in zip(d["emulated"][:2], d["plain_f32"][:2]):
        assert e <= 2 * p, d


def test_one_plain_tf32_pass_would_not():
    """hi·hi alone (one TF32 pass, ~3 decimal digits) leaves G and UᵀZ past
    the 1e-5 bound, tens of times farther from float64 than float32 is."""
    d = distances(5700, 56, 16, passes=1)
    for e, p in zip(d["emulated"][:2], d["plain_f32"][:2]):
        assert e > 1e-5 and e > 10 * p, d


def test_one_accumulator_per_chunk_would_drift():
    """One chunk of 20,000 rows: the three passes of every step straight
    into one accumulator, rounded toward zero 7,500 times, leave G past the
    bound (8.4e-5 of float64); a fresh accumulator per step, added rounding
    to nearest, keeps it within (1.2e-6)."""
    d = distances(20000, 56, 16, per_step=False, cluster=1, chunks=1)
    assert d["emulated"][0] > 1e-5, d
    d = distances(20000, 56, 16, cluster=1, chunks=1)
    assert max(d["emulated"]) <= 1e-5, d


if __name__ == "__main__":
    for shape in [(5700, 56, 16), (1500, 232, 32)]:
        for passes in (3, 1):
            print(distances(*shape, passes))
    print(distances(20000, 56, 16, per_step=False, cluster=1, chunks=1))
    print(distances(20000, 56, 16, cluster=1, chunks=1))
