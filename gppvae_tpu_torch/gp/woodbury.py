"""Woodbury / matrix-determinant-lemma path for the low-rank GP prior.

Counterpart of gppvae_tpu/gp/woodbury.py; see its docstring for the algebra.
K = U Uᵀ + v_n I is never materialized, with U = [√v_1·V_1 | … ] (N×R) and
B = I_R + UᵀU / v_n:

    log|K|       = N·log v_n + log|B|
    tr(Zᵀ K⁻¹ Z) = (‖Z‖² − ‖L_B⁻¹ UᵀZ‖² / v_n) / v_n
    K(*,·) K⁻¹ Z = U* · (B⁻¹ UᵀZ) / v_n

The NLL goes through the two kernels (`ops.factor_prep` →
`ops.woodbury_nll_core`). The R×R Cholesky and triangular solves of the
factorization, the predictive posterior and the streaming update
(`extend_posterior_core`) use torch.linalg, as the JAX package leaves them
to XLA; the Gram and projection there are plain products (`ops.gram` and
`ops.matmul_tn` have no Pallas kernel in the JAX package).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from gppvae_tpu_torch import ops

_LOG2PI = math.log(2.0 * math.pi)

# floor added to exp(log_vn) by variances_from_log: keeps B = I + G/v_n
# factorizable even if the noise variance collapses during joint training
MIN_V_NOISE = 1e-6


def variances_from_log(log_vs, log_vn, min_v_noise: float = MIN_V_NOISE):
    """(v_sig, v_noise) from the trainers' log-parametrization, floored."""
    return torch.exp(log_vs), torch.exp(log_vn) + min_v_noise


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def scaled_features(Vs: Sequence[torch.Tensor], v_sigs: Sequence) -> torch.Tensor:
    """U = [√v_1·V_1 | … | √v_k·V_k]."""
    parts = [
        torch.sqrt(torch.as_tensor(v, dtype=V.dtype, device=V.device)) * V
        for V, v in zip(Vs, v_sigs, strict=True)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class GPFactors(NamedTuple):
    """Woodbury factors of K = U Uᵀ + v_n I (see gppvae_tpu.gp.GPFactors)."""

    U: torch.Tensor
    G: torch.Tensor
    Lb: torch.Tensor
    v_noise: torch.Tensor
    logdet: torch.Tensor


def factorize(Vs, v_sigs, v_noise) -> GPFactors:
    """Woodbury factors for K = Σ_r v_r V_r V_rᵀ + v_n I."""
    U = scaled_features(_as_list(Vs), _as_list(v_sigs))
    N, R = U.shape
    v_noise = torch.as_tensor(v_noise, dtype=U.dtype, device=U.device)
    G = U.T @ U
    B = torch.eye(R, dtype=U.dtype, device=U.device) + G / v_noise
    Lb = torch.linalg.cholesky(B)
    logdet = N * torch.log(v_noise) + 2.0 * torch.sum(torch.log(torch.diagonal(Lb)))
    return GPFactors(U=U, G=G, Lb=Lb, v_noise=v_noise, logdet=logdet)


def kinv_z_core(factors: GPFactors, Z: torch.Tensor) -> torch.Tensor:
    """M = B⁻¹ UᵀZ / v_n, the (R, L) core of every K⁻¹-apply."""
    UtZ = factors.U.T @ Z
    W = torch.linalg.solve_triangular(factors.Lb, UtZ, upper=False)
    M = torch.linalg.solve_triangular(factors.Lb.T, W, upper=True)
    return M / factors.v_noise


def gp_nll_from_features(
    Z: torch.Tensor,
    Vs,
    v_sigs,
    v_noise,
    *,
    include_const: bool = True,
    num_rows: int | None = None,
) -> torch.Tensor:
    """Exact NLL of Z (iid columns) under N(0, K) as a differentiable
    function of (Z, Vs, variances), through the fused kernels: the function
    the Taylor surrogate differentiates. num_rows: the true N when Z and Vs
    carry trailing zero rows (default Z.shape[0])."""
    U = scaled_features(_as_list(Vs), _as_list(v_sigs))
    _, L = Z.shape
    N = num_rows if num_rows is not None else Z.shape[0]
    G, UtZ, znorm2 = ops.factor_prep(U, Z)
    v_noise = torch.as_tensor(v_noise, dtype=Z.dtype, device=Z.device)
    nll = ops.woodbury_nll_core(G, UtZ, znorm2, v_noise, N, L)
    if not include_const:
        nll = nll - 0.5 * N * L * _LOG2PI
    return nll


class PosteriorCore(NamedTuple):
    """N-independent core of the trained GP posterior (M = B⁻¹UᵀZ/v_n, the
    Gram G, L_B and v_n; see gppvae_tpu.gp.PosteriorCore)."""

    M: torch.Tensor
    G: torch.Tensor
    Lb: torch.Tensor
    v_noise: torch.Tensor


def posterior_core(factors: GPFactors, Z: torch.Tensor) -> PosteriorCore:
    """Fold the training latents into the R-sized predictive core."""
    return PosteriorCore(M=kinv_z_core(factors, Z), G=factors.G, Lb=factors.Lb,
                         v_noise=factors.v_noise)


def extend_posterior_core(core: PosteriorCore, Vs_new, v_sigs, Z_new: torch.Tensor) -> PosteriorCore:
    """Fold n new observed rows (scaled features U₊, latents Z₊) into the
    core without the original training set, in O(n·R² + R³):

        G' = G + U₊ᵀU₊,   B' = I + G'/v_n,   M' = B'⁻¹ (B·M + U₊ᵀZ₊/v_n)

    since B·M = UᵀZ/v_n. Equal, up to rounding, to refactorizing over the
    union of all rows; v_n and the variances stay fixed (conditioning, not
    training)."""
    U_new = scaled_features(_as_list(Vs_new), _as_list(v_sigs))
    R = core.G.shape[0]
    if U_new.shape[1] != R:
        raise ValueError(
            f"new rows build rank {U_new.shape[1]} features but the core "
            f"is rank {R}; pass the feature config the core was built with"
        )
    G2 = core.G + U_new.T @ U_new
    B2 = torch.eye(R, dtype=G2.dtype, device=G2.device) + G2 / core.v_noise
    Lb2 = torch.linalg.cholesky(B2)
    # B·M recovers UᵀZ/v_n from the old core; add the new rows' projection
    rhs = (core.M + core.G @ core.M / core.v_noise
           + U_new.T @ Z_new.to(U_new.dtype) / core.v_noise)
    M2 = torch.cholesky_solve(rhs, Lb2, upper=False)
    return PosteriorCore(M=M2, G=G2, Lb=Lb2, v_noise=core.v_noise)


def predict_from_core(V_star, core: PosteriorCore, v_sigs, *, return_var: bool = False):
    """Predictive mean z* = U* M (and the per-row variance
    u*ᵀu* + v_n − u*ᵀ G B⁻¹ u* / v_n) for new rows."""
    U_star = scaled_features(_as_list(V_star), _as_list(v_sigs))
    mean = U_star @ core.M
    if not return_var:
        return mean
    Y = torch.cholesky_solve(U_star.T, core.Lb, upper=False)  # B⁻¹ U*ᵀ
    quad = torch.sum(U_star.T * (core.G @ Y), dim=0) / core.v_noise
    var = torch.sum(U_star * U_star, dim=1) + core.v_noise - quad
    return mean, var


def predict_cov_from_core(V_star, core: PosteriorCore, v_sigs):
    """Joint predictive posterior over a request batch: mean (n, L) and the
    full n×n covariance shared by the L latent dims,

        Cov = U* U*ᵀ + v_n I − U* G B⁻¹ U*ᵀ / v_n = U* B⁻¹ U*ᵀ + v_n I,

    whose diagonal is predict_from_core's variance."""
    U_star = scaled_features(_as_list(V_star), _as_list(v_sigs))
    mean = U_star @ core.M
    Y = torch.cholesky_solve(U_star.T, core.Lb, upper=False)  # B⁻¹ U*ᵀ
    eye = torch.eye(U_star.shape[0], dtype=U_star.dtype, device=U_star.device)
    return mean, U_star @ Y + core.v_noise * eye


def predict_latents(V_star, factors: GPFactors, Z: torch.Tensor, v_sigs, *,
                    return_var: bool = False):
    """GP-predictive latents for out-of-sample rows:
    z* = K(*, train) K⁻¹ Z = U* · (B⁻¹ UᵀZ) / v_n."""
    return predict_from_core(V_star, posterior_core(factors, Z), v_sigs,
                             return_var=return_var)
