"""The collectives of the mesh's axes: all_reduce, broadcast and the model
axis's gather, counted.

Counterpart of the psums the JAX package places under its mesh (the R×R Gram
and R×L projection in gppvae_tpu/ops/dispatch.py:179-201, the minibatch
gradients, the metrics) and of the activation collectives XLA's SPMD
partitioner inserts for a weight split over the `model` axis. Each call
names its axis ('data', 'model' or 'world'; mesh.DataGroup.axis) and runs on
that axis's process group: R-sized sums and gradients go over the data axis
only, a tensor-parallel layer's activations over its model row. Only
`all_reduce` and `broadcast` are needed on gloo, the two collectives gloo
runs on CUDA tensors as well as on CPU ones; the gather is an all-reduce of
a zero-filled full-size buffer there (x + 0 is exact) and
all_gather_into_tensor on NCCL, as the model group's backend says.

Each call adds one to its group's `counts` under (kind, bytes): the kind
alone on the data axis (and on the 1-D mesh, whose world is its data axis),
'model.<kind>' / 'world.<kind>' on the others, so a caller can read what
crossed each axis (`summary`): the port's stand-in for the JAX package's HLO
wire audit (parallel/spmd_audit.py).

`all_reduce_sum` is differentiable: its backward is again a sum all-reduce
of the cotangents. With each rank backpropagating its share value / world of
a replicated value, a rank-local input (a row of U or Z) then gets its whole
gradient, and a replicated input (a variance parameter) gets its rank's
part, which the caller sums over the ranks (gp.taylor_expand).

`copy_to_model` and `gather_columns` are the column-parallel pair of a layer
whose weight is split by output features (tensor.py, models/vae.py): the
first is the identity whose backward sums the input's cotangent over the
model row (each rank's product saw only its output columns), the second
assembles the full output from the model ranks' blocks and hands each rank
its block of the cotangent.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gppvae_tpu_torch.parallel.mesh import DataGroup

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _record(group: DataGroup, axis: str, kind: str, nbytes: int) -> None:
    label, _ = group.axis(axis)
    group.counts[(kind if label == "data" else f"{label}.{kind}", nbytes)] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(group: DataGroup, tensor: torch.Tensor, op: str = "sum",
               axis: str = "data") -> torch.Tensor:
    """In place over the ranks of `axis` (no autograd); returns `tensor`."""
    _record(group, axis, "all_reduce", _nbytes(tensor))
    dist.all_reduce(tensor, op=_OPS[op], group=group.axis(axis)[1])
    return tensor


def broadcast(group: DataGroup, tensor: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """In place from the first rank of `axis` (group.root); returns `tensor`."""
    _record(group, axis, "broadcast", _nbytes(tensor))
    dist.broadcast(tensor, src=group.root(axis), group=group.axis(axis)[1])
    return tensor


def gather(group: DataGroup, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks of a tensor (this rank's is `x`), concatenated
    along `dim` in model-rank order (no autograd)."""
    _, pg = group.axis("model")
    m, dim = group.model_size, dim % x.dim()
    x = x.detach().contiguous()
    k = x.shape[dim]
    shape = [*x.shape[:dim], m * k, *x.shape[dim + 1:]]
    _record(group, "model", "gather", _nbytes(x) * m)
    if dist.get_backend(pg) == "nccl":
        out = x.new_empty((m * x.shape[0], *x.shape[1:]))  # the blocks along dim 0
        dist.all_gather_into_tensor(out, x, group=pg)
        return out.view(m, *x.shape).movedim(0, dim).reshape(shape)
    full = x.new_zeros(shape)
    full.narrow(dim, group.model_rank * k, k).copy_(x)
    dist.all_reduce(full, group=pg)
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, all_reduce(ctx.group, grad.contiguous().clone(), axis="model")


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, dim):
        ctx.dim, ctx.k = dim % x.dim(), x.shape[dim]
        ctx.start = group.model_rank * ctx.k
        return gather(group, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.narrow(ctx.dim, ctx.start, ctx.k).contiguous(), None


def copy_to_model(group: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """x itself; its backward sums the cotangent over the model row."""
    return _CopyToModel.apply(group, x)


def gather_columns(group: DataGroup, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The full output of a split layer from this rank's block `x` of it
    along `dim` (gather); its backward returns this rank's block of the
    cotangent, which is whole and alike on every rank of the model row."""
    return _GatherColumns.apply(group, x, dim)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like) -> list[torch.Tensor]:
    return [part.reshape(t.shape).clone()
            for t, part in zip(like, torch.split(flat, [t.numel() for t in like]))]


def _flat_sum(group: DataGroup, tensors) -> list[torch.Tensor]:
    """Sums of `tensors` over the data axis through one all_reduce of their
    concatenation (they share a dtype and a device)."""
    return _unflat(all_reduce(group, _flat(tensors)), tensors)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_flat_sum(group, [t.detach() for t in tensors]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_flat_sum(ctx.group, grads))


def all_reduce_sum(group: DataGroup | None, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The sums of `tensors` over the data axis, in one collective;
    differentiable (the backward sums the cotangents over the same ranks).
    group=None: the tensors themselves."""
    if group is None:
        return tensors
    return _AllReduceSum.apply(group, *tensors)


def all_reduce_grads(group: DataGroup, params, extra: torch.Tensor,
                     shards=None) -> torch.Tensor:
    """Sum every parameter's .grad (zeros where it is None: a rank with no
    rows in the step) and `extra` over the data axis in one all_reduce; the
    sums replace the .grad of each parameter. Returns the summed `extra`.

    On a mesh with a model axis, `shards` (one bool per parameter) marks the
    blocks of split weights, whose sums are whole for their columns. Every
    other sum should be alike on the ranks of a model row, which computed it
    from the same rows; one broadcast from the row's first rank makes it so
    bit for bit (a CUDA backward that sums with atomics may differ in the
    last bits between two processes)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    *summed, extra = _flat_sum(group, [*grads, extra.to(grads[0].dtype)])
    if group.model_size > 1:
        shards = shards or [False] * len(params)
        same = [g for g, s in zip(summed, shards) if not s] + [extra]
        agreed = _unflat(broadcast(group, _flat(same), axis="model"), same)
        extra = agreed.pop()
        agreed = iter(agreed)
        summed = [g if s else next(agreed) for g, s in zip(summed, shards)]
    for p, g in zip(params, summed):
        p.grad = g
    return extra


def check_replicated(group: DataGroup | None, tensors, what: str, axis: str = "world") -> None:
    """Raise on every rank unless each float32 tensor holds the same bits on
    every rank of `axis`: a checksum of its bits per tensor, and one
    all_reduce(max) of [c, −c] compares the largest with the smallest."""
    if group is None:
        return
    sums = []
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"check_replicated takes float32 tensors, got {t.dtype}")
        sums.append(t.detach().contiguous().view(torch.int32).to(torch.int64).sum())
    c = torch.stack(sums)
    both = all_reduce(group, torch.cat([c, -c]), op="max", axis=axis).cpu()
    hi, lo = both[:len(c)], -both[len(c):]
    differ = torch.nonzero(hi != lo).flatten().tolist()
    if differ:
        raise RuntimeError(f"{what}: tensors {differ} of {len(c)} differ between the "
                           f"{group.size(axis)} ranks (rank {group.global_rank})")


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
