"""Loss terms shared by the training drivers.

Counterpart of gppvae_tpu/train/losses.py, with its conventions: images
y ∈ [0, 1], decoders emit logits, ŷ = sigmoid(logits); per-sample terms are
summed over pixels / latent dims and returned per sample (B,). No term
makes the host wait for the device: a number such as σ_y becomes a 0-d
tensor by a fill on the device (`_like`), not by a host-to-device copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_recon_nll(y: torch.Tensor, y_hat: torch.Tensor, sigma_y):
    """(recon (B,), mse (B,)): ‖y − ŷ‖²/(2σ²) + (D/2)·log(2πσ²) and the
    per-sample pixel MSE."""
    D = math.prod(y.shape[1:])
    sq = torch.sum(((y - y_hat) ** 2).reshape(y.shape[0], -1), dim=1)
    var = _like(sigma_y, y) ** 2
    recon = sq / (2.0 * var) + 0.5 * D * torch.log(2.0 * math.pi * var)
    return recon, sq / D


def _like(v, y: torch.Tensor) -> torch.Tensor:
    """v as a 0-d tensor of y's dtype on y's device. A number is filled in
    on the device (the same bits as torch.as_tensor's), so the host does
    not wait there: a host-to-device copy would wait for every kernel
    queued before it."""
    if torch.is_tensor(v):
        return torch.as_tensor(v, dtype=y.dtype, device=y.device)
    return torch.full((), v, dtype=y.dtype, device=y.device)


# |logit| above which f32 sigmoid rounds to exactly 0/1 is ~16.6; the
# barrier sits just below that cliff (see gppvae_tpu/train/losses.py)
SAT_LOGIT_BOUND = 15.0


def logit_saturation_penalty(logits: torch.Tensor,
                             bound: float = SAT_LOGIT_BOUND) -> torch.Tensor:
    """Per-sample Σ relu(|logit| − bound)²: identically zero while the
    logits stay in the range where the sigmoid still has a gradient."""
    excess = F.relu(torch.abs(logits) - bound)
    return torch.sum((excess ** 2).reshape(logits.shape[0], -1), dim=1)


def kl_standard_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(N(μ, diag e^logvar) ‖ N(0, I))."""
    return 0.5 * torch.sum(mu**2 + torch.exp(logvar) - 1.0 - logvar, dim=1)


def neg_entropy(logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample −H[q(z|y)] up to a constant: −½ Σ logvar (the pen_term)."""
    return -0.5 * torch.sum(logvar, dim=1)
