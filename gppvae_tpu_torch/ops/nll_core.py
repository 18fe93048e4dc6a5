"""woodbury_nll_core: Cholesky of B = I + G/v_n, log-det, solves and NLL.

Counterpart of gppvae_tpu/ops/pallas_chol.py (`nll_core_pallas`, whose
Pallas kernel `_nll_core_pallas` this module's CUDA kernel replaces). The
kernel is `csrc/nll_core.cu`: a blocked Cholesky in panels of 32 columns
that carries [UtZ | I] along, so that W = L_B⁻¹UtZ and X = L_B⁻¹ come out of
the factorization; one CTA with everything in shared memory while it fits
(R = 232, L = 32 takes 224 KB), one cooperative launch on the output buffer
above that, in fp32 (see the note at the top of that file for what bounds
it on the H100). It takes any R.

Which version runs is decided by the tensor's device alone: a CPU tensor
takes the plain PyTorch version, a CUDA float32 tensor launches the kernel,
anything else raises (float64 on CUDA included). Both sit inside
one autograd.Function that saves X = L_B⁻¹ and W = L_B⁻¹UtZ and computes the
closed-form backward of `_core_bwd` (pallas_chol.py:202-222) with
torch.matmul, so the hand-derived backward runs, and is tested, on the CPU
too.
"""

from __future__ import annotations

import math

import torch

from gppvae_tpu_torch.ops import _build
from gppvae_tpu_torch.ops.factor_prep import _check_cuda_f32, _check_device

_LOG2PI = math.log(2.0 * math.pi)


def nll_core_torch(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """Plain version: (nll, X = L_B⁻¹, W = L_B⁻¹UtZ). Counts its calls in
    `nll_core_torch.calls` and those on a CUDA tensor in
    `nll_core_torch.cuda_calls`."""
    nll_core_torch.calls += 1
    if G.is_cuda:
        nll_core_torch.cuda_calls += 1
    R = G.shape[0]
    eye = torch.eye(R, dtype=G.dtype, device=G.device)
    Lb = torch.linalg.cholesky(eye + G / vn)
    W = torch.linalg.solve_triangular(Lb, UtZ, upper=False)
    X = torch.linalg.solve_triangular(Lb, eye, upper=False)
    logdet = n_rows * torch.log(vn) + 2.0 * torch.sum(torch.log(torch.diagonal(Lb)))
    quad = (zn - torch.sum(W * W) / vn) / vn
    nll = 0.5 * (l_dims * logdet + quad + n_rows * l_dims * _LOG2PI)
    return nll, X, W


nll_core_torch.calls = nll_core_torch.cuda_calls = 0


def woodbury_nll_core_torch(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """Plain version of the NLL alone, differentiable by autograd — the
    counterpart of gppvae_tpu.ops.dispatch._xla_woodbury_nll_core."""
    return nll_core_torch(G, UtZ, zn, vn, n_rows, l_dims)[0]


def launch_nll_core(G, UtZ, zn, vn, n_rows: int, l_dims: int):
    """Run the CUDA kernel on float32 CUDA tensors G (R, R), UtZ (R, L) and
    0-d zn, vn. Returns (nll (), X (R, R), W (R, L)) as new tensors; counts
    launches in `launch_nll_core.launches`."""
    _check_cuda_f32(G, UtZ, zn, vn)
    R = G.shape[0]
    if G.shape != (R, R) or UtZ.dim() != 2 or UtZ.shape[0] != R:
        raise ValueError(f"nll_core wants G (R, R), UtZ (R, L); got "
                         f"{tuple(G.shape)}, {tuple(UtZ.shape)}")
    if zn.numel() != 1 or vn.numel() != 1:
        raise ValueError("nll_core wants scalar zn and vn")
    L = UtZ.shape[1]
    if R < 1 or L < 1:
        raise ValueError(f"nll_core needs R, L >= 1; got {R}, {L}")
    G, UtZ = G.contiguous(), UtZ.contiguous()
    zn, vn = zn.reshape(()).contiguous(), vn.reshape(()).contiguous()
    lib = _build.load()
    dev = G.device
    with torch.cuda.device(dev):
        # scratch only where the work does not fit one CTA's shared memory
        n_scratch = lib.gppvae_nll_core_scratch(R, L)
        scratch = (torch.empty(n_scratch, device=dev, dtype=torch.float32)
                   if n_scratch else None)
        nll = torch.empty((), device=dev, dtype=torch.float32)
        X = torch.empty((R, R), device=dev, dtype=torch.float32)
        W = torch.empty((R, L), device=dev, dtype=torch.float32)
        err = lib.gppvae_nll_core(
            G.data_ptr(), UtZ.data_ptr(), zn.data_ptr(), vn.data_ptr(), nll.data_ptr(),
            X.data_ptr(), W.data_ptr(), None if scratch is None else scratch.data_ptr(),
            R, L, int(n_rows), int(l_dims), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "nll_core kernel")
    launch_nll_core.launches += 1
    return nll, X, W


launch_nll_core.launches = 0


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
