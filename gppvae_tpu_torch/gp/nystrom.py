"""Nyström rank compression via pivoted Cholesky landmark selection.

Counterpart of gppvae_tpu/gp/nystrom.py (see its docstring for the method):

    K = V Vᵀ ≈ Φ Φᵀ,   Φ = V V_Sᵀ L_SS⁻ᵀ,   V_S V_Sᵀ = L_SS L_SSᵀ

Landmark selection runs once on the host in float64 numpy, as in the JAX
package; Φ is differentiable in V.
"""

from __future__ import annotations

import numpy as np
import torch


def pivoted_cholesky_landmarks(V, m: int, tol: float = 1e-10) -> np.ndarray:
    """Greedy pivoted-Cholesky selection of ≤ m landmark row indices of
    K = V Vᵀ (never materialized). Returns int32 indices, fewer than m if the
    residual diagonal drops below tol·max-diag (rank found)."""
    V = np.asarray(V, dtype=np.float64)
    n = V.shape[0]
    m = min(m, n)
    d = np.sum(V * V, axis=1)  # residual diagonal of K
    scale = float(d.max()) if n else 0.0
    L = np.zeros((n, m))  # partial Cholesky columns
    idx = []
    for k in range(m):
        p = int(np.argmax(d))
        if d[p] <= tol * scale:
            break
        idx.append(p)
        col = V @ V[p] - L[:, :k] @ L[p, :k]  # K[:, p] − Σ L L[p]
        L[:, k] = col / np.sqrt(d[p])
        d = np.maximum(d - L[:, k] ** 2, 0.0)
    return np.asarray(idx, dtype=np.int32)


def nystrom_features(V: torch.Tensor, landmark_idx, jitter: float = 1e-10) -> torch.Tensor:
    """Φ = V V_Sᵀ L_SS⁻ᵀ (N, len(landmark_idx)), so that Φ Φᵀ is the Nyström
    approximation of V Vᵀ. The jitter scales with the landmark kernel's
    trace (the diagonal's sum: torch.trace's gradient reads its grad back
    on the host). A Cholesky that fails gives NaN, as
    jax.lax.linalg.cholesky does, and never a host sync."""
    idx = torch.as_tensor(landmark_idx, dtype=torch.int64, device=V.device)
    V_S = V[idx]  # (m, R)
    C = V @ V_S.T  # (N, m) cross-covariance K(·, S)
    K_SS = V_S @ V_S.T
    m = K_SS.shape[0]
    eps = jitter * (torch.diagonal(K_SS).sum() / m + 1.0)
    L_SS, info = torch.linalg.cholesky_ex(
        K_SS + eps * torch.eye(m, dtype=V.dtype, device=V.device))
    L_SS = torch.where(info == 0, L_SS, torch.full_like(L_SS, float("nan")))
    return torch.linalg.solve_triangular(L_SS, C.T, upper=False).T
