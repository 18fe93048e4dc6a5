"""First-order Taylor surrogate of the full-dataset GP NLL.

Counterpart of gppvae_tpu/gp/taylor.py; see its docstring for the
construction. Once per epoch the exact NLL is evaluated at the refreshed
latents Z₀ and features V₀ and its gradients are taken by autodiff; each
minibatch then carries

    gp_term(I) = Σ_{n∈I} ⟨dZ_n, z_n⟩ + Σ_{n∈I} ⟨dV_n, v_n⟩ + (|I|/N)·⟨dθ, θ⟩

so that the gradients accumulated over one epoch equal the exact
full-dataset gradient at the expansion point.

Under a data group (parallel/) Z₀ and V₀ are the rank's rows and nll_fn's
value is every rank's alike (its N-sized sums are all-reduced, gp/woodbury.py).
Each rank differentiates value / world: the all-reduce's backward sums
those shares, so dZ and dV come out whole for the rank's rows; a variance
parameter's gradient comes out as the rank's part (log_vs through the
rank's rows of U, log_vn as a 1/world share of the replicated core), and
one all-reduce of daux makes it whole on every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gppvae_tpu_torch.parallel.collectives import all_reduce_sum


class TaylorCoefficients(NamedTuple):
    """Expansion point value and exact gradients of the full-data GP NLL
    (all detached constants)."""

    value: torch.Tensor  # () nll at the expansion point
    dZ: torch.Tensor  # (N, L)
    dV: torch.Tensor | list  # (N, R), or one per random effect
    daux: dict  # ∂nll/∂(variance raw params)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def taylor_expand(
    nll_fn: Callable,
    Z0: torch.Tensor,
    V0,
    aux0: dict,
    *,
    group=None,
) -> TaylorCoefficients:
    """nll_fn(Z, V, aux) and its gradients at (Z0, V0, aux0), each taken as
    a fresh leaf. V0 is one (N, R) tensor or a list of them (with a group:
    the rank's rows, and nll_fn reduces over the same group)."""
    Z = _leaf(Z0)
    is_list = isinstance(V0, (list, tuple))
    Vs = [_leaf(v) for v in (V0 if is_list else [V0])]
    keys = sorted(aux0)
    aux = {k: _leaf(aux0[k]) for k in keys}
    with torch.enable_grad():
        value = nll_fn(Z, Vs if is_list else Vs[0], aux)
        share = value if group is None else value / group.world
        grads = torch.autograd.grad(share, [Z, *Vs, *(aux[k] for k in keys)])
    dZ, dVs, daux = grads[0], list(grads[1:1 + len(Vs)]), grads[1 + len(Vs):]
    if keys:
        daux = all_reduce_sum(group, *daux)
    return TaylorCoefficients(
        value=value.detach(), dZ=dZ, dV=dVs if is_list else dVs[0],
        daux=dict(zip(keys, daux)),
    )


def surrogate_batch_term(
    coeffs: TaylorCoefficients,
    idx: torch.Tensor,
    z_batch: torch.Tensor,
    v_batch,
    aux: dict,
    num_total: int,
    *,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-minibatch GP loss term from the surrogate. idx: (b,) dataset
    rows; z_batch (b, L) and v_batch (b, R) (or a list matching coeffs.dV)
    differentiable; aux: the live variance raw params. weights: optional
    (b,) 0/1 row mask; the variance share then scales with the valid rows."""
    dVs = coeffs.dV if isinstance(coeffs.dV, list) else [coeffs.dV]
    vs = v_batch if isinstance(v_batch, (list, tuple)) else [v_batch]
    dZb = coeffs.dZ[idx]
    if weights is None:
        term = torch.sum(dZb * z_batch) + sum(
            torch.sum(g[idx] * v) for g, v in zip(dVs, vs, strict=True)
        )
        frac = idx.shape[0] / num_total
    else:
        # promote the 0/1 weights, never downcast (gppvae_tpu/gp/taylor.py:
        # 93-101): a low-precision row count would break the variance share
        weights = weights.to(torch.promote_types(weights.dtype, z_batch.dtype))
        term = torch.sum(weights * torch.sum(dZb * z_batch, dim=1)) + sum(
            torch.sum(weights * torch.sum(g[idx] * v, dim=1))
            for g, v in zip(dVs, vs, strict=True)
        )
        frac = torch.sum(weights) / num_total
    aux_dot = sum(torch.sum(coeffs.daux[k] * aux[k]) for k in sorted(coeffs.daux))
    return term + frac * aux_dot
