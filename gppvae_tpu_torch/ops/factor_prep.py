"""factor_prep: (UᵀU, UᵀZ, ‖Z‖²) in one pass over the N rows.

Counterpart of gppvae_tpu/ops/pallas_gemm.py (`factor_prep_pallas`, whose
Pallas kernel `_factor_prep_pallas` this module's CUDA kernel replaces). The
kernel is `csrc/factor_prep.cu`: one launch, row chunks streamed through a
cp.async ring in fp32 FMA, the chunks' partials summed in a fixed order by
the last CTA of each tile (see the note at the top of that file for what
bounds it on the H100 and why it is built that way). The library is loaded
and its ctypes signatures set once per process (`_build.load`). The launch's
shape is planned here, by `plan_factor_prep` from the device's SM count
(read once per device, `_build.device_props`), and cached per (device,
shape); a launch is one ctypes call that takes the plan's integers. The
workspace and the ticket counters are cached per device and stream.

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


def factor_prep_torch(U: torch.Tensor, Z: torch.Tensor):
    """Plain version: (UᵀU, UᵀZ, ‖Z‖²) with ‖Z‖² a 0-d tensor. Counts its
    calls in `factor_prep_torch.calls` and those on a CUDA tensor in
    `factor_prep_torch.cuda_calls`."""
    factor_prep_torch.calls += 1
    if U.is_cuda:
        factor_prep_torch.cuda_calls += 1
    return U.T @ U, U.T @ Z, torch.sum(Z * Z)


factor_prep_torch.calls = factor_prep_torch.cuda_calls = 0


# csrc/factor_prep.cu's tiling: 256 threads of 4×4 outputs, rows staged 32 at
# a time; tiles of at most 64 rows and 96 columns; N cut into chunks of at
# least 160 rows, at most two CTAs per SM
THREADS, KS, MAX_EDGE, MAX_TN = 256, 32, 64, 24
MIN_ROWS_PER_CHUNK, CTAS_PER_SM = 160, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class FactorPrepPlan:
    """The launch's shape: threads along a tile's rows and columns (tm, tn),
    the grid of 4·tm × 4·tn tiles over [G | UᵀZ], those computed (the tiles
    wholly above G's diagonal are mirrored, not computed), and N's chunks."""
    tm: int
    tn: int
    row_tiles: int
    col_tiles: int
    tiles: int
    chunks: int
    rows_per_chunk: int

    @property
    def workspace(self) -> int:
        """Floats of partial tiles and ‖Z‖² partials (0 when N is not split)."""
        return 0 if self.chunks == 1 else (
            self.tiles * self.chunks * 16 * self.tm * self.tn + self.chunks)

    @property
    def tickets(self) -> int:
        """Ticket counters, one per computed tile (0 when N is not split)."""
        return 0 if self.chunks == 1 else self.tiles


def _row_tile_span(tm: int, tn: int, col_tiles: int, R: int, rt: int) -> tuple[int, int]:
    below = min(_cdiv((rt + 1) * 4 * tm, 4 * tn), col_tiles)
    return below, max(R // (4 * tn), below)


def plan_factor_prep(N: int, R: int, L: int, props: dict) -> FactorPrepPlan:
    """The kernel's launch shape for U (N, R), Z (N, L) on a device with
    props["sms"] SMs (the kernel checks it against its own tiling)."""
    row_tiles = _cdiv(R, MAX_EDGE)
    tm = _cdiv(_cdiv(R, row_tiles), 4)
    # at most 96 columns: the two stages stay within 40 KB of shared memory
    # and one pass of the 256 threads covers a staged row's copies
    tn_max = min(THREADS // tm, MAX_TN)
    col_tiles = _cdiv(R + L, 4 * tn_max)
    tn = _cdiv(_cdiv(R + L, col_tiles), 4)
    tiles = 0
    for rt in range(row_tiles):
        below, start = _row_tile_span(tm, tn, col_tiles, R, rt)
        tiles += below + col_tiles - start
    chunks = max(1, min(CTAS_PER_SM * props["sms"] // tiles, _cdiv(N, MIN_ROWS_PER_CHUNK)))
    rows_per_chunk = _cdiv(_cdiv(N, chunks), KS) * KS
    return FactorPrepPlan(tm, tn, row_tiles, col_tiles, tiles, _cdiv(N, rows_per_chunk),
                          rows_per_chunk)


@functools.lru_cache(maxsize=None)
def _plan(index: int, N: int, R: int, L: int) -> FactorPrepPlan:
    return plan_factor_prep(N, R, L, _build.device_props(index))


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


def _launch(lib, p: FactorPrepPlan, U, Z, G, UtZ, zn, ws, tickets, stream: int) -> int:
    (N, R), L = U.shape, Z.shape[1]
    u, z = U.data_ptr(), Z.data_ptr()
    vec = R % 4 == 0 and L % 4 == 0 and u % 16 == 0 and z % 16 == 0
    return lib.gppvae_factor_prep(
        u, z, G.data_ptr(), UtZ.data_ptr(), zn.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        N, R, L, p.tm, p.tn, p.row_tiles, p.col_tiles, p.tiles, p.chunks, p.rows_per_chunk,
        int(vec), stream)


def launch_factor_prep(U: torch.Tensor, Z: torch.Tensor):
    """Run the CUDA kernel on float32 CUDA tensors U (N, R) and Z (N, L).
    Returns (G (R, R), UtZ (R, L), zn ()) as new tensors; counts launches in
    `launch_factor_prep.launches`. One ctypes call, with the plan cached per
    (device, shape)."""
    _check_factor_prep(U, Z)
    U, Z = U.contiguous(), Z.contiguous()
    (N, R), L = U.shape, Z.shape[1]
    lib = _build.load()
    dev = U.device
    with _on(dev):
        plan = _plan(dev.index, N, R, L)
        stream = _stream(dev)
        ws, tickets = _scratch(dev, stream, plan)
        G, UtZ, zn = _outputs(dev, R, L)
        err = _launch(lib, plan, U, Z, G, UtZ, zn, ws, tickets, stream)
    _build.check(err, "factor_prep kernel")
    launch_factor_prep.launches += 1
    return G, UtZ, zn


launch_factor_prep.launches = 0

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
