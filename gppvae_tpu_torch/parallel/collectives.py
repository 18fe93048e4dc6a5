"""The collectives of the data axis: all_reduce and broadcast, counted.

Counterpart of the psums the JAX package places under its mesh (the R×R Gram
and R×L projection in gppvae_tpu/ops/dispatch.py:179-201, the minibatch
gradients, the metrics). Only `all_reduce` and `broadcast` are used: the two
collectives gloo runs on CUDA tensors as well as on CPU ones.

Each call adds one to its DataGroup's `counts` under (kind, bytes), so a
caller can read what crossed the ranks (`summary`): the port's stand-in for
the JAX package's HLO wire audit (parallel/spmd_audit.py).

`all_reduce_sum` is differentiable: its backward is again a sum all-reduce
of the cotangents. With each rank backpropagating its share value / world of
a replicated value, a rank-local input (a row of U or Z) then gets its whole
gradient, and a replicated input (a variance parameter) gets its rank's
part, which the caller sums over the ranks (gp.taylor_expand).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gppvae_tpu_torch.parallel.mesh import DataGroup

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _record(group: DataGroup, kind: str, tensor: torch.Tensor) -> None:
    group.counts[(kind, tensor.numel() * tensor.element_size())] += 1


def all_reduce(group: DataGroup, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In place over the ranks (no autograd); returns `tensor`."""
    _record(group, "all_reduce", tensor)
    dist.all_reduce(tensor, op=_OPS[op])
    return tensor


def broadcast(group: DataGroup, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In place from rank `src`; returns `tensor`."""
    _record(group, "broadcast", tensor)
    dist.broadcast(tensor, src=src)
    return tensor


def _flat_sum(group: DataGroup, tensors) -> list[torch.Tensor]:
    """Sums of `tensors` over the ranks through one all_reduce of their
    concatenation (they share a dtype and a device)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(group, flat)
    return [part.reshape(t.shape).clone()
            for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors]))]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_flat_sum(group, [t.detach() for t in tensors]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_flat_sum(ctx.group, grads))


def all_reduce_sum(group: DataGroup | None, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The sums of `tensors` over the ranks, in one collective; differentiable
    (the backward sums the cotangents over the ranks). group=None: the
    tensors themselves."""
    if group is None:
        return tensors
    return _AllReduceSum.apply(group, *tensors)


def all_reduce_grads(group: DataGroup, params, extra: torch.Tensor) -> torch.Tensor:
    """Sum every parameter's .grad (zeros where it is None: a rank with no
    rows in the step) and `extra` over the ranks in one all_reduce; the sums
    replace the .grad of each parameter. Returns the summed `extra`."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    *summed, extra = _flat_sum(group, [*grads, extra.to(grads[0].dtype)])
    for p, g in zip(params, summed):
        p.grad = g
    return extra


def check_replicated(group: DataGroup | None, tensors, what: str) -> None:
    """Raise on every rank unless each float32 tensor holds the same bits on
    every rank: a checksum of its bits per tensor, and one all_reduce(max) of
    [c, −c] compares the largest with the smallest."""
    if group is None:
        return
    sums = []
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"check_replicated takes float32 tensors, got {t.dtype}")
        sums.append(t.detach().contiguous().view(torch.int32).to(torch.int64).sum())
    c = torch.stack(sums)
    both = all_reduce(group, torch.cat([c, -c]), op="max").cpu()
    hi, lo = both[:len(c)], -both[len(c):]
    differ = torch.nonzero(hi != lo).flatten().tolist()
    if differ:
        raise RuntimeError(f"{what}: tensors {differ} of {len(c)} differ between the "
                           f"{group.world} ranks (rank {group.rank})")


def summary(counts) -> dict:
    """{kind: {'calls', 'bytes', 'max_bytes'}} of a DataGroup's counts (or
    of the difference of two snapshots)."""
    out: dict = {}
    for (kind, nbytes), calls in counts.items():
        row = out.setdefault(kind, {"calls": 0, "bytes": 0, "max_bytes": 0})
        row["calls"] += calls
        row["bytes"] += calls * nbytes
        row["max_bytes"] = max(row["max_bytes"], nbytes)
    return out
