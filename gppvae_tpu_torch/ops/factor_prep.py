"""factor_prep: (UᵀU, UᵀZ, ‖Z‖²) in one pass over the N rows.

Counterpart of gppvae_tpu/ops/pallas_gemm.py (`factor_prep_pallas`, whose
Pallas kernel `_factor_prep_pallas` this module's CUDA kernel replaces). The
kernel is `csrc/factor_prep.cu`: one launch, row chunks streamed through a
cp.async ring in fp32 FMA, the chunks' partials summed in a fixed order by
the last CTA of each tile (see the note at the top of that file for what
bounds it on the H100 and why it is built that way). The library is loaded
and its ctypes signatures set once per process (`_build.load`); the
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


def launch_factor_prep(U: torch.Tensor, Z: torch.Tensor):
    """Run the CUDA kernel on float32 CUDA tensors U (N, R) and Z (N, L).
    Returns (G (R, R), UtZ (R, L), zn ()) as new tensors; counts launches in
    `launch_factor_prep.launches`."""
    _check_cuda_f32(U, Z)
    if U.dim() != 2 or Z.dim() != 2 or U.shape[0] != Z.shape[0]:
        raise ValueError(f"factor_prep wants U (N, R), Z (N, L); got "
                         f"{tuple(U.shape)}, {tuple(Z.shape)}")
    N, R = U.shape
    L = Z.shape[1]
    if N < 1 or R < 1 or L < 1:
        raise ValueError(f"factor_prep needs N, R, L >= 1; got {N}, {R}, {L}")
    U = U.contiguous()
    Z = Z.contiguous()
    lib = _build.load()
    dev = U.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, tickets = _scratch(lib, dev, stream, N, R, L)
        G = torch.empty((R, R), device=dev, dtype=torch.float32)
        UtZ = torch.empty((R, L), device=dev, dtype=torch.float32)
        zn = torch.empty((), device=dev, dtype=torch.float32)
        err = lib.gppvae_factor_prep(
            U.data_ptr(), Z.data_ptr(), G.data_ptr(), UtZ.data_ptr(), zn.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(), N, R, L, stream,
        )
    _build.check(err, "factor_prep kernel")
    launch_factor_prep.launches += 1
    return G, UtZ, zn


launch_factor_prep.launches = 0

# (device, stream) → (workspace, tickets), kept between calls and grown when
# a shape needs more: calls on one stream run in order, so they can share
# it, and the kernel leaves every ticket at 0 for the next call.
_SCRATCH: dict = {}


def _scratch(lib, dev, stream: int, N: int, R: int, L: int):
    n_ws = lib.gppvae_factor_prep_workspace(N, R, L)
    n_tk = lib.gppvae_factor_prep_tickets(N, R, L)
    ws, tickets = _SCRATCH.get((dev, stream), (None, None))
    if ws is None or ws.numel() < n_ws or tickets.numel() < n_tk:
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
