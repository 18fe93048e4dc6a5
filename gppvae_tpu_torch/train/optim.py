"""Adam guarded against gradient spikes.

Counterpart of `spike_guard` / `make_optimizer` in
gppvae_tpu/train/train_gppvae.py:233-320. One Σg² pass over the gradients
gives both the global-norm clip (exact pass-through below the threshold,
(g/‖g‖)·c above it, as optax.clip_by_global_norm) and the non-finite skip:
a step whose Σg² is not finite leaves the parameters, the Adam moments and
the step count untouched. Adam is torch.optim.Adam, whose update equals
optax.adam's (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt).
"""

from __future__ import annotations

from typing import Iterable

import torch


class GuardedAdam:
    """torch.optim.Adam behind the fused clip + non-finite skip.

    Deciding the skip reads Σg² on the host, one device sync per step."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 clip_grad_norm: float = 1e5):
        self.params = list(params)
        self.clip = clip_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.notfinite_count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """Clip and apply the gradients; False if the step was skipped."""
        grads = [p.grad for p in self.params if p.grad is not None]
        sumsq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g in grads:
            sumsq = sumsq + torch.sum(g * g)
        if not bool(torch.isfinite(sumsq)):
            self.notfinite_count += 1
            return False
        if self.clip and self.clip > 0:
            norm = torch.sqrt(sumsq)
            below = norm < self.clip
            for g in grads:
                g.copy_(torch.where(below, g, (g / norm.to(g.dtype)) * self.clip))
        self.adam.step()
        return True
