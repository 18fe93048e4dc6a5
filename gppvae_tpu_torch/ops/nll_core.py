"""woodbury_nll_core: Cholesky of B = I + G/v_n, log-det, solves and NLL.

Counterpart of gppvae_tpu/ops/pallas_chol.py (`nll_core_pallas`, whose
Pallas kernel `_nll_core_pallas` this module's CUDA kernel replaces). The
kernel is `csrc/nll_core.cu`: a blocked Cholesky in panels of 32 columns
that carries [UtZ | I] along, so that W = L_B⁻¹UtZ and X = L_B⁻¹ come out of
the factorization, its products on the tensor cores in split TF32, in f32
out (see the note at the top of that file for what bounds it on the H100).
It takes any R, by one of three drivers that `plan_nll_core` chooses from R,
L and the device's properties (read once per device, `_build.device_props`):
one CTA for small R, a thread-block cluster that spreads the matrix over its
CTAs' shared memory for the middle band, one cooperative grid above. The
plan is cached per (device, shape), and a launch is one ctypes call that
takes the plan's integers; a cluster the device cannot hold
(cudaOccupancyMaxActiveClusters) is planned as the grid instead and counted
in `launch_nll_core.cluster_refused`, never tried and caught.

Which version runs is decided by the tensor's device alone: a CPU tensor
takes the plain PyTorch version, a CUDA float32 tensor launches the kernel,
anything else raises (float64 on CUDA included). Both sit inside
one autograd.Function that saves X = L_B⁻¹ and W = L_B⁻¹UtZ and computes the
closed-form backward of `_core_bwd` (pallas_chol.py:202-222) with
torch.matmul, so the hand-derived backward runs, and is tested, on the CPU
too.
"""

from __future__ import annotations

import functools
import math

import torch

from dataclasses import dataclass

from gppvae_tpu_torch.ops import _build
from gppvae_tpu_torch.ops.factor_prep import (
    _cdiv,
    _check_cuda_f32,
    _check_device,
    _on,
    _stream,
)
from gppvae_tpu_torch.utils.timers import TRACER, Counters, count

_LOG2PI = math.log(2.0 * math.pi)


def nll_core_torch(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """Plain version: (nll, X = L_B⁻¹, W = L_B⁻¹UtZ). Counts its calls in
    the counter `nll_core_torch.calls` and those on a CUDA tensor in
    `nll_core_torch.cuda_calls` (utils/timers.py)."""
    count("nll_core_torch.calls")
    if G.is_cuda:
        count("nll_core_torch.cuda_calls")
    R = G.shape[0]
    eye = torch.eye(R, dtype=G.dtype, device=G.device)
    Lb = torch.linalg.cholesky(eye + G / vn)
    W = torch.linalg.solve_triangular(Lb, UtZ, upper=False)
    X = torch.linalg.solve_triangular(Lb, eye, upper=False)
    logdet = n_rows * torch.log(vn) + 2.0 * torch.sum(torch.log(torch.diagonal(Lb)))
    quad = (zn - torch.sum(W * W) / vn) / vn
    nll = 0.5 * (l_dims * logdet + quad + n_rows * l_dims * _LOG2PI)
    return nll, X, W


def woodbury_nll_core_torch(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """Plain version of the NLL alone, differentiable by autograd — the
    counterpart of gppvae_tpu.ops.dispatch._xla_woodbury_nll_core."""
    return nll_core_torch(G, UtZ, zn, vn, n_rows, l_dims)[0]


# csrc/nll_core.cu's shapes: panels and row blocks of 32, D and the panel
# copy with rows of 36 floats, 256 threads (8 warps) per CTA, clusters of at
# most 16 CTAs
NB, DLD, PLD, SLD, THREADS, WARPS, MAX_CLUSTER = 32, 36, 36, 36, 256, 8, 16
DRIVERS = ("cta", "cluster", "grid")  # their codes in the C entry: 0, 1, 2
# The cut-overs, from the card's times (tools/torch_nll_core_drivers.py,
# PERF.md): the one-CTA driver up to CTA_MAX_R, the cluster up to
# CLUSTER_MAX_R where its shared memory holds the rows, the grid beyond
CTA_MAX_R = 128
CLUSTER_MAX_R = 480


@dataclass(frozen=True)
class NLLCorePlan:
    """One launch: the driver, its CTAs (the cluster's size for "cluster"),
    the dynamic shared memory per CTA (bytes; cta and cluster) and the global
    scratch (floats; grid)."""
    driver: str
    ctas: int
    smem: int
    scratch: int


def padded_prefix(r: int) -> int:
    """Where packed row r of M starts: Σ_{i<r} of row i's i + 1 floats,
    each padded to a multiple of 4."""
    K, j = r >> 2, r & 3
    return 8 * K * (K + 1) + 4 * j * (K + 1)


def block_owner(b: int, C: int) -> int:
    """The CTA of a cluster of C that holds row block b: blocks of 32 rows
    dealt in snake order (0 … C−1, C−1 … 0, …)."""
    cyc, pos = divmod(b, C)
    return C - 1 - pos if cyc & 1 else pos


def row_blocks(R: int, C: int) -> list[list[tuple[int, int, int]]]:
    """Per CTA of C, the row blocks it holds as (block, offset, floats) of
    its packed M, in order."""
    held: list[list[tuple[int, int, int]]] = [[] for _ in range(C)]
    for b in range(_cdiv(R, NB)):
        q = block_owner(b, C)
        n = padded_prefix(min(NB * (b + 1), R)) - padded_prefix(NB * b)
        off = held[q][-1][1] + held[q][-1][2] if held[q] else 0
        held[q].append((b, off, n))
    return held


def dist_smem(R: int, L: int, C: int) -> int:
    """Bytes of dynamic shared memory per CTA of the cta (C = 1) and cluster
    drivers: M (the most any CTA holds), W and Pb (32 rows of L and of 36 per
    block held), D, step 1's two 32×36 blocks and inverse diagonal, the
    reduction buffer, the partial sums, each block's owner, three pointers
    per block and the mbarrier (csrc/nll_core.cu dist_layout)."""
    nblk = _cdiv(R, NB)
    mfl = max(sum(n for _, _, n in held) for held in row_blocks(R, C))
    wbl = _cdiv(nblk, C)
    floats = (mfl + wbl * NB * (L + PLD) + NB * DLD + 2 * NB * SLD + NB + THREADS + 4
              + ((nblk + 3) & ~3) + 6 * nblk + 4)
    return 4 * floats


def _grid_ctas(R: int, L: int, props: dict) -> int:
    """One CTA per SM, no more than the most 32×32 tiles of any step need."""
    nblk, wt = _cdiv(R, NB), _cdiv(L, NB)
    most = max(max((nblk - k - 1) + wt + k,
                   sum((ib - k) + wt + k for ib in range(k + 1, nblk)))
               for k in range(nblk))
    return max(1, min(props["sms"] * min(props["grid_per_sm"], 1), _cdiv(most, WARPS)))


def plan_nll_core(R: int, L: int, props: dict, driver: str | None = None,
                  cluster: int | None = None) -> NLLCorePlan:
    """The launch for G (R, R), UtZ (R, L) on a device with `props`
    (`_build.device_props`). Without `driver`: the one-CTA driver up to
    CTA_MAX_R where its shared memory fits, else a cluster where the rows'
    blocks of 32 spread over at most props["max_cluster"] CTAs fit their
    shared memory and R ≤ CLUSTER_MAX_R, else the grid. `driver` and
    `cluster` force a choice (for measuring); a forced one that cannot run
    raises."""
    nblk = _cdiv(R, NB)
    optin = props["smem_optin"]
    # a CTA updates the rows it holds: as few blocks per CTA as the largest
    # cluster allows, and as few CTAs as give that (18 blocks: 9 CTAs of 2)
    most = min(props["max_cluster"], MAX_CLUSTER)
    C = cluster or _cdiv(nblk, _cdiv(nblk, most))
    if driver is None:
        if R <= CTA_MAX_R and dist_smem(R, L, 1) <= optin:
            driver = "cta"
        elif C >= 2 and R <= CLUSTER_MAX_R and dist_smem(R, L, C) <= optin:
            driver = "cluster"
        else:
            driver = "grid"
    if driver == "cta":
        plan = NLLCorePlan("cta", 1, dist_smem(R, L, 1), 0)
    elif driver == "cluster":
        plan = NLLCorePlan("cluster", C, dist_smem(R, L, C), 0)
        if not 2 <= C <= min(MAX_CLUSTER, props["max_cluster"]):
            raise ValueError(f"nll_core: no cluster of {C} CTAs on this device")
    elif driver == "grid":
        return NLLCorePlan("grid", _grid_ctas(R, L, props), 0, R * PLD + NB * DLD)
    else:
        raise ValueError(f"nll_core: unknown driver {driver!r}; one of {DRIVERS}")
    if plan.smem > optin:
        raise ValueError(f"nll_core: the {driver} driver needs {plan.smem} bytes of shared "
                         f"memory per CTA at R={R}, L={L}; the device allows {optin}")
    return plan


def _clusters_fit(index: int, C: int, smem: int) -> int:
    """How many clusters of C CTAs with `smem` bytes each device `index`
    holds at once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(index):
        n = _build.load().gppvae_nll_core_clusters(C, smem)
    if n < 0:
        _build.check(-n, "nll_core cluster occupancy")
    return n


@functools.lru_cache(maxsize=None)
def _plan(index: int, R: int, L: int) -> NLLCorePlan:
    """plan_nll_core on device `index`, once per (device, shape)."""
    props = _build.device_props(index)
    plan = plan_nll_core(R, L, props)
    if plan.driver == "cluster" and _clusters_fit(index, plan.ctas, plan.smem) < 1:
        launch_nll_core.cluster_refused += 1
        plan = plan_nll_core(R, L, props, driver="grid")
    return plan


def _check_nll_core(G, UtZ, zn, vn) -> None:
    _check_cuda_f32(G, UtZ, zn, vn)
    R = G.shape[0]
    if G.shape != (R, R) or UtZ.dim() != 2 or UtZ.shape[0] != R:
        raise ValueError(f"nll_core wants G (R, R), UtZ (R, L); got "
                         f"{tuple(G.shape)}, {tuple(UtZ.shape)}")
    if zn.numel() != 1 or vn.numel() != 1:
        raise ValueError("nll_core wants scalar zn and vn")
    if R < 1 or UtZ.shape[1] < 1:
        raise ValueError(f"nll_core needs R, L >= 1; got {R}, {UtZ.shape[1]}")


def _outputs(dev, R: int, L: int, plan: NLLCorePlan):
    """nll, X, W and the grid's scratch (None for the other drivers)."""
    return (torch.empty((), device=dev, dtype=torch.float32),
            torch.empty((R, R), device=dev, dtype=torch.float32),
            torch.empty((R, L), device=dev, dtype=torch.float32),
            torch.empty(plan.scratch, device=dev, dtype=torch.float32) if plan.scratch else None)


def _launch(lib, plan: NLLCorePlan, G, UtZ, zn, vn, nll, X, W, scratch, n_rows: int,
            l_dims: int, stream: int) -> int:
    R, L = UtZ.shape
    return lib.gppvae_nll_core(
        G.data_ptr(), UtZ.data_ptr(), zn.data_ptr(), vn.data_ptr(), nll.data_ptr(),
        X.data_ptr(), W.data_ptr(), None if scratch is None else scratch.data_ptr(),
        R, L, int(n_rows), int(l_dims), DRIVERS.index(plan.driver), plan.ctas, plan.smem, stream)


def launch_nll_core(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """Run the CUDA kernel on float32 CUDA tensors G (R, R), UtZ (R, L) and
    0-d zn, vn. Returns (nll (), X (R, R), W (R, L)) as new tensors; counts
    launches in the counter `launch_nll_core.launches` and per driver in
    `launch_nll_core.drivers.<driver>` (`launch_nll_core.drivers` reads
    them). One ctypes call, with the plan cached per (device, shape)."""
    _check_nll_core(G, UtZ, zn, vn)
    G, UtZ = G.contiguous(), UtZ.contiguous()
    zn, vn = zn.reshape(()).contiguous(), vn.reshape(()).contiguous()
    R, L = UtZ.shape
    lib = _build.load()
    dev = G.device
    with _on(dev):
        plan = _plan(dev.index, R, L)
        nll, X, W, scratch = _outputs(dev, R, L, plan)
        err = _launch(lib, plan, G, UtZ, zn, vn, nll, X, W, scratch, n_rows, l_dims,
                      _stream(dev))
    _build.check(err, "nll_core kernel")
    count("launch_nll_core.launches")
    count(f"launch_nll_core.drivers.{plan.driver}")
    return nll, X, W


launch_nll_core.drivers = Counters(TRACER, "launch_nll_core.drivers", DRIVERS)
launch_nll_core.cluster_refused = 0


class NLLCore(torch.autograd.Function):
    """Fused Woodbury NLL core with the hand-derived backward of
    pallas_chol._core_bwd, from the forward's residuals X and W."""

    @staticmethod
    def forward(ctx, G, UtZ, zn, vn, n_rows, l_dims):
        if G.is_cuda:
            nll, X, W = launch_nll_core(G, UtZ, zn, vn, n_rows, l_dims)
        else:
            with torch.no_grad():
                nll, X, W = nll_core_torch(G, UtZ, zn, vn, n_rows, l_dims)
        ctx.save_for_backward(G, UtZ, zn, vn, X, W)
        ctx.n_rows, ctx.l_dims = n_rows, l_dims
        return nll

    @staticmethod
    def backward(ctx, ct):
        G, UtZ, zn, vn, X, W = ctx.saved_tensors
        n, Ld = ctx.n_rows, ctx.l_dims
        M = X.T @ W      # B⁻¹ UtZ
        Binv = X.T @ X   # B⁻¹
        MMt = M @ M.T
        T = torch.sum(UtZ * M)
        gG = 0.5 * (Ld * Binv / vn + MMt / vn**3)
        gUtZ = -M / vn**2
        gzn = 1.0 / (2.0 * vn)
        gvn = 0.5 * (
            Ld * (n / vn - torch.sum(Binv * G) / vn**2)
            - zn / vn**2
            + 2.0 * T / vn**3
            - torch.sum(G * MMt) / vn**4
        )
        return (ct * gG, ct * gUtZ, (ct * gzn).reshape(zn.shape),
                (ct * gvn).reshape(vn.shape), None, None)


def woodbury_nll_core(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """The NLL from the R-sized core (n_rows, l_dims: the true N and L):
    the plain version for CPU tensors, the CUDA kernel for float32 CUDA
    tensors; raises otherwise."""
    _check_device(G, UtZ, zn, vn)
    return NLLCore.apply(G, UtZ, zn, vn, n_rows, l_dims)
