"""factor_prep: (UᵀU, UᵀZ, ‖Z‖²) in one pass over the N rows.

Counterpart of gppvae_tpu/ops/pallas_gemm.py (`factor_prep_pallas`, whose
Pallas kernel `_factor_prep_pallas` this module's CUDA kernel replaces). The
kernel is `csrc/factor_prep.cu`: one launch; a producer warp streams each
CTA's rows of U and Z into a ring of tensor-map copies, eight warps take the
products on the tensor cores in split TF32, and the chunks of N are summed
in a fixed order, in thread-block clusters over distributed shared memory
and then by ticket (see the note at the top of that file for what bounds it
on the H100 and why it is built that way). The library is
loaded and its ctypes signatures set once per process (`_build.load`). The
launch's shape is planned here, by `plan_factor_prep` from the shape, the
pointers' alignment and how many CTAs the device holds (read once per
device, `_capacity`), and cached per (device, shape, alignment);
a launch is one ctypes call that takes the plan's integers. The workspace
and the ticket counters are cached per device and stream.

Which version runs is decided by the tensor's device alone: a CPU tensor
takes the plain PyTorch version, a CUDA float32 tensor launches the kernel,
anything else raises. Both sit inside one autograd.Function whose backward
is the closed form of `_fp_bwd` (pallas_gemm.py:197-204) in torch.matmul.

Under a data group (`group=`, parallel/) the kernel runs on the rank's rows
and one differentiable all-reduce sums (G, UᵀZ, ‖Z‖²) over the ranks: the
counterpart of `_factor_prep_shard_map` (gppvae_tpu/ops/dispatch.py:179-201).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch

from gppvae_tpu_torch.ops import _build
from gppvae_tpu_torch.parallel.collectives import all_reduce_sum
from gppvae_tpu_torch.utils.timers import count


def factor_prep_torch(U: torch.Tensor, Z: torch.Tensor):
    """Plain version: (UᵀU, UᵀZ, ‖Z‖²) with ‖Z‖² a 0-d tensor. Counts its
    calls in the counter `factor_prep_torch.calls` and those on a CUDA
    tensor in `factor_prep_torch.cuda_calls` (utils/timers.py)."""
    count("factor_prep_torch.calls")
    if U.is_cuda:
        count("factor_prep_torch.cuda_calls")
    return U.T @ U, U.T @ Z, torch.sum(Z * Z)


# csrc/factor_prep.cu's shape: eight consumer warps of 32×32 blocks (two
# each) and one producer warp, stages of 32 rows; tiles of BT = 32, 64 or 128
# rows of G, the diagonal tile taking Z's first zw columns beside G's lower
# blocks (zw ≤ 32, or 64 at BT 64, so that its blocks fit the warps)
KS = 32
TILE_EDGES = (32, 64, 128)
STAGES = {32: 8, 64: 6, 128: 5}
CLUSTERS = (8, 4, 2, 1)
# how the producer warp copies rows (the C enum Copy): where rows are 16-byte
# aligned, boxes of a 2-D tensor map ("tma"; a stage cut by a chunk's end
# takes one bulk copy per row), else 4-byte cp.asyncs
COPIES = {"cp4": 0, "tma": 1}
# N's chunks: at most one per stage of rows. The plan takes the chunks and
# the cluster size that its cost model gives the least time, among those
# that run in one wave: a CTA's stages of 32 rows (µs each, per tile edge),
# its share of the final values to store (µs per float), and with more than
# one cluster per tile the second pass (workspace, fence, ticket) and the
# last CTA's sum (µs per float read). The constants are device times of the
# kernel's steps on an H100 80GB HBM3 (tools/torch_factor_prep_steps.py).
MIN_ROWS_PER_CHUNK = KS
STAGE_US = {32: 1.1, 64: 1.6, 128: 2.9}
STORE_US_PER_FLOAT = 1e-3
SECOND_PASS_US = 3.0
SUM_US_PER_FLOAT = 5.7e-5


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_edge(R: int) -> int:
    """BT: the smallest tile edge that holds R, up to 128."""
    return next((bt for bt in TILE_EDGES if R <= bt), TILE_EDGES[-1])


def z_most(bt: int) -> int:
    """The most Z columns of a diagonal tile (csrc zmax)."""
    return 64 if bt == 64 else 32


def partial_floats(bt: int, zw: int) -> int:
    """Floats of one partial tile: BT × (BT + zw, Z padded to 8) and ‖Z‖²,
    padded to 16 bytes (csrc partial_floats)."""
    return (bt * (bt + (zw + 7) // 8 * 8) + 1 + 3) // 4 * 4


def smem_bytes(bt: int, stages: int) -> int:
    """Dynamic shared memory of the BT kernel: the ring of `stages` stages of
    A and B rows (BT + 8 floats each), which the partial tile and the final
    values reuse, and 128 bytes to align it."""
    return 4 * (max(stages * 2 * KS * (bt + 8), 2 * partial_floats(bt, z_most(bt))) + 32)


@dataclass(frozen=True)
class FactorPrepPlan:
    """The launch's shape: the tile edge bt, Z's columns per Z tile (zw) and
    the tiles (row_tiles·(row_tiles−1)/2 left of G's diagonal, row_tiles
    diagonal ones, the rest of Z's columns), N's chunks in clusters of
    `cluster` CTAs, the ring's stages, how rows are copied (COPIES), and
    the dynamic shared memory."""
    bt: int
    zw: int
    row_tiles: int
    z_tiles: int
    tiles: int
    cluster: int
    chunks: int
    rows_per_chunk: int
    stages: int
    copy: str
    smem: int

    @property
    def ctas(self) -> int:
        return self.tiles * self.chunks

    @property
    def workspace(self) -> int:
        """Floats of the clusters' partial tiles (0 with one cluster per tile)."""
        clusters = self.chunks // self.cluster
        return 0 if clusters == 1 else self.tiles * clusters * partial_floats(self.bt, self.zw)

    @property
    def tickets(self) -> int:
        """Ticket counters, one per tile and cluster rank (0 with one cluster
        per tile)."""
        return 0 if self.chunks == self.cluster else self.tiles * self.cluster


def _tiles(R: int, L: int, bt: int) -> tuple[int, int, int]:
    """(row tiles, Z tiles, tiles) at tile edge bt."""
    row_tiles, z_tiles = _cdiv(R, bt), _cdiv(L, min(L, z_most(bt)))
    return row_tiles, z_tiles, row_tiles * (row_tiles - 1) // 2 + row_tiles * z_tiles


def plan_factor_prep(N: int, R: int, L: int, capacity: dict,
                     aligned: bool = True) -> FactorPrepPlan:
    """The kernel's launch shape for U (N, R), Z (N, L) on a device that
    holds capacity[bt][cluster] CTAs of the BT kernel in clusters of that
    size at once (`_capacity`; the kernel checks the plan against its own
    tiling). `aligned`: both pointers are 16-byte aligned. N's chunks and
    the cluster size: the least estimate_us among the plans that run in one
    wave (one chunk per tile where the tiles alone fill more)."""
    bt = tile_edge(R)
    zw = min(L, z_most(bt))
    tiles = _tiles(R, L, bt)[2]
    most = _cdiv(N, MIN_ROWS_PER_CHUNK)
    options = [(estimate_us(N, bt, zw, c, n), -c, n) for c in CLUSTERS
               for n in range(c, min(capacity[bt][c] // tiles, most) + 1, c)]
    _, c, n = min(options) if options else (0.0, -1, 1)
    return make_plan(N, R, L, bt, -c, n, aligned)


def make_plan(N: int, R: int, L: int, bt: int, cluster: int, chunks: int,
              aligned: bool = True) -> FactorPrepPlan:
    """The plan of tile edge `bt` with N in `chunks` chunks, in clusters of
    `cluster` CTAs: plan_factor_prep's choice, or one that a tool times."""
    if bt not in TILE_EDGES:
        raise ValueError(f"no factor_prep tile edge {bt}; have {TILE_EDGES}")
    if cluster not in CLUSTERS or chunks % cluster:
        raise ValueError(f"{chunks} chunks cannot run in clusters of {cluster}")
    copy = "tma" if aligned and R % 4 == 0 and L % 4 == 0 else "cp4"
    return FactorPrepPlan(bt, min(L, z_most(bt)), *_tiles(R, L, bt), cluster, chunks,
                          _cdiv(N, chunks), STAGES[bt], copy, smem_bytes(bt, STAGES[bt]))


def estimate_us(N: int, bt: int, zw: int, cluster: int, chunks: int) -> float:
    """The plan's cost model (see STAGE_US): µs of the longest CTA's stages,
    its store, and the second pass where chunks > cluster."""
    k = chunks // cluster
    share = partial_floats(bt, zw) / cluster
    est = _cdiv(_cdiv(N, chunks), KS) * STAGE_US[bt] + share * STORE_US_PER_FLOAT
    return est + (SECOND_PASS_US + k * share * SUM_US_PER_FLOAT if k > 1 else 0.0)


def capacity(lib, bt: int, cluster: int) -> int:
    """CTAs of the BT kernel in clusters of `cluster` that the current
    device holds at once (the C query)."""
    n = lib.gppvae_factor_prep_capacity(bt, smem_bytes(bt, STAGES[bt]), cluster)
    _build.check(-n if n < 0 else 0, "factor_prep capacity")
    return n


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> dict:
    """capacity() of CUDA device `index` for every tile edge and cluster
    size, read once per device."""
    lib = _build.load()
    with torch.cuda.device(index):
        return {bt: {c: capacity(lib, bt, c) for c in CLUSTERS} for bt in TILE_EDGES}


@functools.lru_cache(maxsize=None)
def _plan(index: int, N: int, R: int, L: int, aligned: bool = True) -> FactorPrepPlan:
    return plan_factor_prep(N, R, L, _capacity(index), aligned)


def _on(dev: torch.device):
    """torch.cuda.device(dev), or nothing where dev is already current."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of `dev`, as the raw handle the C entries
    take (torch.cuda.current_stream(dev).cuda_stream builds a Stream object
    first: several µs per call on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check_factor_prep(U: torch.Tensor, Z: torch.Tensor) -> None:
    _check_cuda_f32(U, Z)
    if U.dim() != 2 or Z.dim() != 2 or U.shape[0] != Z.shape[0]:
        raise ValueError(f"factor_prep wants U (N, R), Z (N, L); got "
                         f"{tuple(U.shape)}, {tuple(Z.shape)}")
    if min(*U.shape, Z.shape[1]) < 1:
        raise ValueError(f"factor_prep needs N, R, L >= 1; got {tuple(U.shape)}, "
                         f"{tuple(Z.shape)}")


def _outputs(dev: torch.device, R: int, L: int):
    return (torch.empty((R, R), device=dev, dtype=torch.float32),
            torch.empty((R, L), device=dev, dtype=torch.float32),
            torch.empty((), device=dev, dtype=torch.float32))


def _aligned(U: torch.Tensor, Z: torch.Tensor) -> bool:
    return U.data_ptr() % 16 == 0 and Z.data_ptr() % 16 == 0


def _launch(lib, p: FactorPrepPlan, U, Z, G, UtZ, zn, ws, tickets, stream: int) -> int:
    (N, R), L = U.shape, Z.shape[1]
    return lib.gppvae_factor_prep(
        U.data_ptr(), Z.data_ptr(), G.data_ptr(), UtZ.data_ptr(), zn.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), N, R, L, p.bt, p.zw, p.tiles, p.cluster, p.chunks, p.rows_per_chunk,
        p.stages, COPIES[p.copy], p.smem, stream)


def launch_factor_prep(U: torch.Tensor, Z: torch.Tensor):
    """Run the CUDA kernel on float32 CUDA tensors U (N, R) and Z (N, L).
    Returns (G (R, R), UtZ (R, L), zn ()) as new tensors; counts launches in
    the counter `launch_factor_prep.launches`. One ctypes call, with the
    plan cached per (device, shape)."""
    _check_factor_prep(U, Z)
    U, Z = U.contiguous(), Z.contiguous()
    (N, R), L = U.shape, Z.shape[1]
    lib = _build.load()
    dev = U.device
    with _on(dev):
        plan = _plan(dev.index, N, R, L, _aligned(U, Z))
        stream = _stream(dev)
        ws, tickets = _scratch(dev, stream, plan)
        G, UtZ, zn = _outputs(dev, R, L)
        err = _launch(lib, plan, U, Z, G, UtZ, zn, ws, tickets, stream)
    _build.check(err, "factor_prep kernel")
    count("launch_factor_prep.launches")
    return G, UtZ, zn


# (device, stream) → (workspace, tickets), kept between calls and grown when
# a shape needs more: calls on one stream run in order, so they can share
# it, and the kernel leaves every ticket at 0 for the next call.
_SCRATCH: dict = {}


def _scratch(dev, stream: int, plan: FactorPrepPlan):
    ws, tickets = _SCRATCH.get((dev, stream), (None, None))
    if ws is None or ws.numel() < plan.workspace or tickets.numel() < plan.tickets:
        n_ws, n_tk = plan.workspace, plan.tickets
        if ws is not None:  # never shrink: shapes may alternate
            n_ws, n_tk = max(n_ws, ws.numel()), max(n_tk, tickets.numel())
        ws = torch.empty(max(n_ws, 1), device=dev, dtype=torch.float32)
        tickets = torch.zeros(max(n_tk, 1), device=dev, dtype=torch.int32)
        _SCRATCH[(dev, stream)] = (ws, tickets)
    return ws, tickets


class FactorPrep(torch.autograd.Function):
    """factor_prep with the closed-form backward of pallas_gemm._fp_bwd:
    dU = U(dG + dGᵀ) + Z·dUtZᵀ, dZ = U·dUtZ + 2·dzn·Z."""

    @staticmethod
    def forward(ctx, U, Z):
        ctx.save_for_backward(U, Z)
        if U.is_cuda:
            return launch_factor_prep(U, Z)
        with torch.no_grad():
            return factor_prep_torch(U, Z)

    @staticmethod
    def backward(ctx, dG, dUtZ, dzn):
        U, Z = ctx.saved_tensors
        dU = U @ (dG + dG.T) + Z @ dUtZ.T
        dZ = U @ dUtZ + (2.0 * dzn) * Z
        return dU, dZ


def factor_prep(U: torch.Tensor, Z: torch.Tensor, group=None):
    """(UᵀU, UᵀZ, ‖Z‖²) for U (N, R), Z (N, L): the plain version for CPU
    tensors, the CUDA kernel for float32 CUDA tensors; raises otherwise.
    With a DataGroup, U and Z are the rank's rows and the three are summed
    over the ranks."""
    _check_device(U, Z)
    return all_reduce_sum(group, *FactorPrep.apply(U, Z))


def _check_device(*ts: torch.Tensor) -> None:
    dev = {t.device.type for t in ts}
    if dev == {"cpu"}:
        return
    if dev == {"cuda"}:
        _check_cuda_f32(*ts)
        return
    raise ValueError(f"tensors must all be on the CPU or all on CUDA; got {dev}")


def _check_cuda_f32(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
