"""Dense (materialized-K) reference formulas: a test oracle only.

Counterpart of gppvae_tpu/gp/dense.py. The Woodbury path never materializes
K; these O(N³) formulas let the tests check it against dense linear algebra
on small N. Nothing on the training or serving path uses them.
"""

from __future__ import annotations

import math

import torch


def materialize_K(Vs, v_sigs, v_noise) -> torch.Tensor:
    """K = Σ_r v_r V_r V_rᵀ + v_n I."""
    if not isinstance(Vs, (list, tuple)):
        Vs, v_sigs = [Vs], [v_sigs]
    N = Vs[0].shape[0]
    K = v_noise * torch.eye(N, dtype=Vs[0].dtype, device=Vs[0].device)
    for V, v in zip(Vs, v_sigs, strict=True):
        K = K + v * (V @ V.T)
    return K


def dense_nll(Z: torch.Tensor, K: torch.Tensor, *, include_const: bool = True) -> torch.Tensor:
    """½[L·log|K| + tr(Zᵀ K⁻¹ Z) (+ N·L·log 2π)] via a dense Cholesky."""
    N, L = Z.shape
    Lk = torch.linalg.cholesky(K)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(Lk)))
    W = torch.linalg.solve_triangular(Lk, Z, upper=False)
    out = 0.5 * (L * logdet + torch.sum(W * W))
    if include_const:
        out = out + 0.5 * N * L * math.log(2.0 * math.pi)
    return out


def dense_predict(K_star_train: torch.Tensor, K: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """z* = K(*, train) K⁻¹ Z by a dense solve."""
    return K_star_train @ torch.linalg.solve(K, Z)


def dense_predict_cov(K_star_train: torch.Tensor, K_star_star: torch.Tensor,
                      K: torch.Tensor) -> torch.Tensor:
    """Cov = K(*,*) − K(*,·) K⁻¹ K(·,*) by a dense solve; K_star_star must
    already hold the new rows' noise term v_n I where the Woodbury side being
    checked adds it (predict_cov_from_core does)."""
    return K_star_star - K_star_train @ torch.linalg.solve(K, K_star_train.T)
