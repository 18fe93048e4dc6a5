"""Adam guarded against gradient spikes, with gradient accumulation.

Counterpart of `spike_guard` / `make_optimizer` / `resolve_grad_accum` in
gppvae_tpu/train/train_gppvae.py:233-336. One Σg² pass over the gradients
gives both the global-norm clip (exact pass-through below the threshold,
(g/‖g‖)·c above it, as optax.clip_by_global_norm) and the non-finite skip:
a step whose Σg² is not finite leaves the parameters, the Adam moments and
the step count untouched. Adam is torch.optim.Adam, whose update equals
optax.adam's (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt).

With accum_steps = k > 1 the guard sits inside optax.MultiSteps: each call
folds the gradients into a running mean (optax's Welford form
acc + (g − acc)/(n + 1)), the parameters stay as they are on k − 1 calls,
and the k-th call hands the mean of the k gradients to the guard and Adam.
The count carries across epochs. A non-finite mini-step makes the mean, and
so the k-th step, non-finite: that step skips. optax then resets the mean
by multiplying it by 0, which keeps a NaN, so every later k-th step skips
too; the port does the same (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Iterable

import torch

from gppvae_tpu_torch.train.batching import num_batches


def resolve_grad_accum(grad_accum_steps: int, num_train: int, batch_size: int) -> int:
    """-1 = auto ⇒ k ≈ (N/bs)/45, the steps per epoch of the benchmark
    shape; a positive k passes through."""
    if grad_accum_steps == -1:
        return max(1, round(num_batches(num_train, batch_size) / 45))
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1 or -1 (auto), got {grad_accum_steps}")
    return grad_accum_steps


class GuardedAdam:
    """torch.optim.Adam behind the fused clip + non-finite skip, every
    `accum_steps` calls on the mean gradient.

    Deciding the skip reads Σg² on the host: one device sync per Adam step,
    so one per `accum_steps` calls."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 clip_grad_norm: float = 1e5, accum_steps: int = 1):
        self.params = list(params)
        self.clip = clip_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.accum_steps = accum_steps
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None  # running mean gradients
        self.notfinite_count = 0
        self.steps = 0  # Adam steps applied

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """Everything the next call reads: Adam's moments and step counts,
        the position inside an accumulation window with its running mean,
        and the counters."""
        return {
            "adam": self.adam.state_dict(),
            "mini_step": self.mini_step,
            "acc": None if self.acc is None else [a.clone() for a in self.acc],
            "notfinite_count": self.notfinite_count,
            "steps": self.steps,
        }

    def load_state_dict(self, state: dict) -> None:
        # the learning rate stays this optimizer's own (optax keeps it
        # outside its state)
        lr = self.adam.param_groups[0]["lr"]
        self.adam.load_state_dict(state["adam"])
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.mini_step = int(state["mini_step"])
        self.acc = None if state["acc"] is None else [
            a.to(device=p.device, dtype=p.dtype) for a, p in zip(state["acc"], self.params)]
        self.notfinite_count = int(state["notfinite_count"])
        self.steps = int(state["steps"])

    @torch.no_grad()
    def step(self) -> bool:
        """Accumulate, or clip and apply; True if the parameters moved."""
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, p in zip(self.acc, self.params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
                a.mul_(0)
            self.mini_step = 0
        return self._guarded_step()

    def _guarded_step(self) -> bool:
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
        self.steps += 1
        return True
