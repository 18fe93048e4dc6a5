"""Covariance feature maps: object/view feature rows → low-rank V.

Counterpart of gppvae_tpu/gp/features.py. The GP feature row of sample n
with object d(n) and view q(n) is v_n = x_{d(n)} ⊗ w_{q(n)}, so that
V Vᵀ = (X Xᵀ)_d ∘ (W Wᵀ)_q: the object×view product kernel at rank M·M_w.

The object kernel is linear, or RBF through random Fourier features of
the normalized object features (`make_rff_map`), optionally compressed onto
landmark objects (`make_x_map('rbf-nystrom')`, gp/nystrom.py). Gathers are
plain indexing: the JAX package's one-hot backward of `take_rows`
(features.py:36-64) worked around TPU scatter and gives the same values.
"""

from __future__ import annotations

import math

import torch

from gppvae_tpu_torch.gp.nystrom import nystrom_features

OBJECT_KERNELS = ("linear", "rbf", "rbf-nystrom")


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


def rff_draws(in_dim: int, num_features: int, seed: int = 0):
    """(Ω (in_dim, m), b (m,)) float32 for `make_rff_map`: Ω ~ N(0, I),
    b ~ U[0, 2π), from a torch.Generator seeded by `seed`. The JAX package
    draws them from threefry (features.py:155-159), which torch cannot
    reproduce; convert.rff_draws_from_map carries the JAX draws over."""
    g = torch.Generator().manual_seed(seed)
    omega = torch.randn((in_dim, num_features), generator=g)
    phase = torch.rand((num_features,), generator=g) * (2.0 * math.pi)
    return omega, phase


def make_rff_map(draws, lengthscale: float = 1.0):
    """Random Fourier feature map φ(f) = √(2/m)·cos(f Ω/ℓ + b), so that
    E[φ(f)·φ(f')] = exp(−‖f−f'‖²/(2ℓ²)). draws: (Ω (in_dim, m), b (m,)),
    from `rff_draws` or injected; they move to the input's device and dtype
    at each call. Returns (map_fn, m)."""
    omega, phase = draws
    if omega.dim() != 2 or tuple(phase.shape) != (omega.shape[1],):
        raise ValueError(f"RFF draws of shapes {tuple(omega.shape)}, {tuple(phase.shape)}; "
                         "want (in_dim, m), (m,)")
    num_features = omega.shape[1]
    scale = math.sqrt(2.0 / num_features)

    def map_fn(F: torch.Tensor) -> torch.Tensor:
        om = omega.to(device=F.device, dtype=F.dtype)
        return scale * torch.cos(F @ (om / lengthscale) + phase.to(device=F.device, dtype=F.dtype))

    return map_fn, num_features


def make_x_map(kind: str, draws=None, lengthscale: float = 1.0, nystrom_idx=None):
    """Object-kernel feature map: 'linear' → None; 'rbf' → the RFF map of
    `draws` (Ω, b); 'rbf-nystrom' → the RFF map compressed onto the landmark
    object rows `nystrom_idx` (rank len(nystrom_idx))."""
    if kind == "linear":
        return None
    if kind not in OBJECT_KERNELS:
        raise ValueError(f"unknown object_kernel {kind!r}")
    if draws is None:
        raise ValueError(f"object_kernel {kind!r} needs the RFF draws (gp.rff_draws)")
    fn, _ = make_rff_map(draws, lengthscale)
    if kind == "rbf":
        return fn
    if nystrom_idx is None:
        raise ValueError("object_kernel 'rbf-nystrom' needs landmark indices "
                         "(the trainer selects them; final_params.pt carries them)")
    idx = torch.as_tensor(nystrom_idx, dtype=torch.int64)
    return lambda F: nystrom_features(fn(F), idx.to(F.device))


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
    """Per-sample feature rows V (n, M'·M_w) from object features X (P, M),
    view features W (Q, M_w) and the (n,) object/view ids; differentiable
    in X and W. x_map: a feature map applied to the (normalized) object
    features, e.g. from make_x_map; None = the linear kernel."""
    if normalize_X:
        X = normalize_rows(X)
    if normalize_W:
        W = normalize_rows(W)
    if x_map is not None:
        X = x_map(X)
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
    """Feature rows of every random effect, in variance order: [object⊗view
    product, *extra_effects], where 'object' adds rows x_d (an effect per
    object shared across views) and 'view' rows w_q."""
    effects = [build_V(X, W, object_ids, view_ids,
                       normalize_X=True, normalize_W=True, x_map=x_map)]
    for e in extra_effects:
        if e == "object":
            effects.append(normalize_rows(X)[object_ids])
        elif e == "view":
            effects.append(normalize_rows(W)[view_ids])
        else:
            raise ValueError(f"unknown extra effect {e!r}; want 'object' or 'view'")
    return effects
