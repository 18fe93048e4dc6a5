"""Covariance feature maps: object/view feature rows → low-rank V.

Counterpart of gppvae_tpu/gp/features.py. The GP feature row of sample n
with object d(n) and view q(n) is v_n = x_{d(n)} ⊗ w_{q(n)}, so that
V Vᵀ = (X Xᵀ)_d ∘ (W Wᵀ)_q: the object×view product kernel at rank M·M_w.

Only the linear object kernel is ported; gathers are plain indexing (the
JAX package's `_take_rows_onehot` worked around TPU scatter).
"""

from __future__ import annotations

import torch


def normalize_rows(X: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Project feature rows to the unit sphere."""
    return X / torch.sqrt(torch.sum(X * X, dim=1, keepdim=True) + eps)


def fourier_view_features(
    angles: torch.Tensor,
    num_freqs: int = 3,
    include_const: bool = True,
) -> torch.Tensor:
    """(Q, 1+2K) unit rows ∝ [1, cos θ, sin θ, …, cos Kθ, sin Kθ] of the
    rotation angles (radians): a normalized periodic view kernel."""
    if angles.dim() != 1:
        raise ValueError(f"angles must be 1-D, got shape {tuple(angles.shape)}")
    if num_freqs < 1:
        raise ValueError(f"num_freqs must be >= 1, got {num_freqs}")
    feats = [torch.ones_like(angles)] if include_const else []
    for k in range(1, num_freqs + 1):
        feats += [torch.cos(k * angles), torch.sin(k * angles)]
    W = torch.stack(feats, dim=1)
    return W / torch.linalg.norm(W, dim=1, keepdim=True)


def polynomial_view_features(positions: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """(Q, degree+1) unit rows ∝ [1, t, …, t^degree], t rescaled to [-1, 1]:
    the view kernel for a linear (non-periodic) view axis such as pose."""
    if positions.dim() != 1:
        raise ValueError(f"positions must be 1-D, got shape {tuple(positions.shape)}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    t = positions
    lo, hi = torch.min(t), torch.max(t)
    t = torch.where(hi > lo, 2.0 * (t - lo) / (hi - lo) - 1.0, t * 0.0)
    W = torch.stack([t**k for k in range(degree + 1)], dim=1)
    return W / torch.linalg.norm(W, dim=1, keepdim=True)


def kron_rows(Xrows: torch.Tensor, Wrows: torch.Tensor) -> torch.Tensor:
    """Row-wise Kronecker (Khatri–Rao) product: (n, M), (n, M_w) → (n, M·M_w)."""
    n, M = Xrows.shape
    n2, Mw = Wrows.shape
    if n != n2:
        raise ValueError(f"row count mismatch: {n} vs {n2}")
    return (Xrows[:, :, None] * Wrows[:, None, :]).reshape(n, M * Mw)


def build_V(
    X: torch.Tensor,
    W: torch.Tensor,
    object_ids: torch.Tensor,
    view_ids: torch.Tensor,
    *,
    normalize_X: bool = True,
    normalize_W: bool = False,
    x_map=None,
) -> torch.Tensor:
    """Per-sample feature rows V (n, M·M_w) from object features X (P, M),
    view features W (Q, M_w) and the (n,) object/view ids; differentiable
    in X and W."""
    if x_map is not None:
        raise NotImplementedError(
            "only the linear object kernel is ported (ROADMAP Queue 1 item 9, "
            "object_kernel rbf / rbf-nystrom)"
        )
    if normalize_X:
        X = normalize_rows(X)
    if normalize_W:
        W = normalize_rows(W)
    return kron_rows(X[object_ids], W[view_ids])


def build_effect_rows(
    X: torch.Tensor,
    W: torch.Tensor,
    object_ids: torch.Tensor,
    view_ids: torch.Tensor,
    *,
    extra_effects: tuple = (),
    x_map=None,
) -> list[torch.Tensor]:
    """Feature rows of every random effect, in variance order. The slice
    ports the object⊗view product effect alone."""
    if extra_effects:
        raise NotImplementedError(
            f"extra_effects {tuple(extra_effects)!r} are not ported "
            "(ROADMAP Queue 1 item 9)"
        )
    return [build_V(X, W, object_ids, view_ids,
                    normalize_X=True, normalize_W=True, x_map=x_map)]
