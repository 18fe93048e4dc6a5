"""Adam guarded against gradient spikes, with gradient accumulation.

Counterpart of `spike_guard` / `make_optimizer` / `resolve_grad_accum` in
gppvae_tpu/train/train_gppvae.py:233-336. One multi-tensor Σg² pass over the
gradients gives both the global-norm clip (exact pass-through below the
threshold, (g/‖g‖)·c above it, as optax.clip_by_global_norm) and the
non-finite skip: a step whose Σg² is not finite leaves the parameters, the
Adam moments and the step count untouched. Adam is torch.optim.Adam's fused
update, which equals optax.adam's (b1 0.9, b2 0.999, eps 1e-8 outside the
sqrt).

Everything is decided on the device, as the JAX spike_guard decides with
selects: the clip is a select of two 0-d factors applied with
`torch._foreach_*` ops, the skip is the fused Adam's `found_inf` (which
holds back the parameters, both moments and the step count), and the skips
are counted in a device counter. A step only enqueues work; the host waits
for the device only where it reads `notfinite_count` or `steps` (the
tracer's read `sync.notfinite`), at most once an epoch. With `capturable`
the fused Adam may be captured in a CUDA graph (train_gppvae's Phase C
step): the same update, its step counts on the device either way; the
host's `guarded` count is then advanced by whoever replays the graph.

With accum_steps = k > 1 the guard sits inside optax.MultiSteps: each call
folds the gradients into a running mean (optax's Welford form
acc + (g − acc)/(n + 1)), the parameters stay as they are on k − 1 calls,
and the k-th call hands the mean of the k gradients to the guard and Adam.
The count carries across epochs. A non-finite mini-step makes the mean, and
so the k-th step, non-finite: that step skips. optax then resets the mean
by multiplying it by 0, which keeps a NaN, so every later k-th step skips
too; the port does the same (ROADMAP Queue 3).

Under tensor parallelism (`shards`: the rank's MeshGroup and which
parameters are blocks of split weights, parallel/tensor.py) Σg² is the whole
model's, as the JAX spike_guard computes it on sharded arrays
(gppvae_tpu/train/train_gppvae.py:233): the blocks' Σg² summed over the
model axis, plus the replicated tensors' Σg² counted once, so every rank
takes the same finite / clip decision. Adam is elementwise and runs on the
blocks as they are. `state_dict` gathers the blocks' moments and running
means whole, and `load_state_dict` takes whole ones and keeps the blocks:
a train state is the same whether one process, data ranks or a mesh wrote
it.
"""

from __future__ import annotations

import functools
from typing import Iterable

import torch

from gppvae_tpu_torch.parallel import all_reduce, gather
from gppvae_tpu_torch.parallel.tensor import block
from gppvae_tpu_torch.train.batching import num_batches
from gppvae_tpu_torch.utils.timers import read


def resolve_grad_accum(grad_accum_steps: int, num_train: int, batch_size: int) -> int:
    """-1 = auto ⇒ k ≈ (N/bs)/45, the steps per epoch of the benchmark
    shape; a positive k passes through."""
    if grad_accum_steps == -1:
        return max(1, round(num_batches(num_train, batch_size) / 45))
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1 or -1 (auto), got {grad_accum_steps}")
    return grad_accum_steps


def _sumsq(grads: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Σ g² over the tensors from one multi-tensor norm pass, in float32 or
    wider (float64 where the gradients are)."""
    if not grads:
        return torch.zeros((), dtype=torch.float32, device=device)
    dtype = functools.reduce(torch.promote_types, (g.dtype for g in grads), torch.float32)
    return torch.sum(torch.stack(torch._foreach_norm(grads, 2, dtype=dtype)) ** 2)


class GuardedAdam:
    """torch.optim.Adam (fused) behind the clip + non-finite skip, every
    `accum_steps` calls on the mean gradient.

    A step makes no host sync: the skip and the clip are decided on the
    device, and `notfinite_count` / `steps` read a device counter."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 clip_grad_norm: float = 1e5, accum_steps: int = 1, shards=None,
                 capturable: bool = False):
        self.params = list(params)
        # (MeshGroup, [is a block per parameter]) under tensor parallelism
        self.group, self.shards = shards if shards and any(shards[1]) else (None, None)
        self.clip = clip_grad_norm
        self.capturable = capturable
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     fused=True, capturable=capturable)
        self.accum_steps = accum_steps
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None  # running mean gradients
        self.guarded = 0  # calls that reached the guard: steps + skips
        self.skipped = torch.zeros((), dtype=torch.int64, device=self.params[0].device)

    @property
    def notfinite_count(self) -> int:
        """Steps skipped because Σg² was not finite (reads the device)."""
        return read("notfinite", int, self.skipped)

    @property
    def steps(self) -> int:
        """Adam steps applied (reads the device)."""
        return self.guarded - self.notfinite_count

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def _whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """A parameter-shaped tensor of parameter i, whole."""
        return gather(self.group, t, 0) if self.shards and self.shards[i] else t

    def _mine(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """A whole parameter-shaped tensor of parameter i, as this rank holds it."""
        return block(self.group, t).clone() if self.shards and self.shards[i] else t

    def state_dict(self) -> dict:
        """Everything the next call reads: Adam's moments and step counts,
        the position inside an accumulation window with its running mean,
        and the counters as ints; whole under tensor parallelism (every
        rank of the model row calls it)."""
        adam = self.adam.state_dict()
        if self.group is not None:
            adam["state"] = {i: {k: self._whole(i, v) if torch.is_tensor(v) and v.dim() else v
                                 for k, v in st.items()} for i, st in adam["state"].items()}
        skipped = self.notfinite_count
        return {
            "adam": adam,
            "mini_step": self.mini_step,
            "acc": None if self.acc is None else [
                self._whole(i, a).clone() for i, a in enumerate(self.acc)],
            "notfinite_count": skipped,
            "steps": self.guarded - skipped,
        }

    def load_state_dict(self, state: dict) -> None:
        # the learning rate stays this optimizer's own (optax keeps it
        # outside its state), and the update the fused one, capturable or
        # not as this one, whatever wrote the state: its step counts then
        # load onto the parameters' device
        lr = self.adam.param_groups[0]["lr"]
        adam = dict(state["adam"], param_groups=[
            {**g, "lr": lr, "fused": True, "capturable": self.capturable}
            for g in state["adam"]["param_groups"]])
        if self.group is not None:
            adam["state"] = {
                i: {k: self._mine(i, v) if torch.is_tensor(v) and v.dim() else v
                    for k, v in st.items()} for i, st in adam["state"].items()}
        self.adam.load_state_dict(adam)
        self.mini_step = int(state["mini_step"])
        self.acc = None if state["acc"] is None else [
            self._mine(i, a).to(device=p.device, dtype=p.dtype)
            for i, (a, p) in enumerate(zip(state["acc"], self.params))]
        skipped = int(state["notfinite_count"])
        self.skipped.fill_(skipped)
        self.guarded = int(state["steps"]) + skipped

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Accumulate, or clip and apply; a 0-d device bool, True if the
        parameters moved."""
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, p in zip(self.acc, self.params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return torch.zeros((), dtype=torch.bool, device=self.skipped.device)
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
                a.mul_(0)
            self.mini_step = 0
        return self._guarded_step()

    def _guarded_step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        device = self.skipped.device
        if self.group is None:
            sumsq = _sumsq(grads, device)
        else:  # the blocks' share from the whole model row, the rest once
            blocks = [p.grad for p, b in zip(self.params, self.shards)
                      if p.grad is not None and b]
            rest = [p.grad for p, b in zip(self.params, self.shards)
                    if p.grad is not None and not b]
            sumsq = _sumsq(rest, device) + all_reduce(self.group, _sumsq(blocks, device),
                                                      axis="model")
        ok = torch.isfinite(sumsq)
        bad = ~ok
        if self.clip and self.clip > 0:
            # optax's select: g below the clip, else (g/‖g‖)·c
            norm = torch.sqrt(sumsq)
            below = norm < self.clip
            torch._foreach_div_(grads, torch.where(below, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(below, 1.0, torch.full_like(norm, self.clip)))
        self.adam.found_inf = bad.float()  # the fused update skips on 1.0
        self.adam.step()
        self.skipped.add_(bad)
        self.guarded += 1
        return ok
