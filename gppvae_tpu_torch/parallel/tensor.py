"""Tensor parallelism: the large weights split by output features over the
model axis of a data × model mesh.

Counterpart of `shard_params_model_axis` (gppvae_tpu/parallel/mesh.py:48-88)
and of the layout XLA's SPMD partitioner fills in for it. The rule is the
JAX package's: a weight splits when it has rank ≥ 2, at least `min_size`
elements and an output dimension that the model axis's size divides. The
output dimension is flax's last axis (a Dense kernel's output features, a
conv kernel's output channels) and torch's first (nn.Linear's (out, in),
nn.Conv2d's OIHW). A weight that qualifies by size but does not divide stays
whole, with ONE warning naming every such weight. Biases and the GP
parameters stay whole: a GP parameter never splits here, where the JAX rule
would split one past `min_size` elements (X of ≥ 2,048 objects × 8), which
is a layout choice with the same math.

A split weight is replaced on each rank of a model row by its contiguous
block of output features, and its layer carries the rank's MeshGroup as
`tp_group`; models/vae.py runs such a layer as copy_to_model → the product
with the block → gather_columns → + the whole bias (collectives.py). The
full weights come back with `gather_state_dict` (for saving and checking)
or `unsplit` (the model whole again); `load_state_dict` narrows full weights
to the blocks (resume).

The trainer reaches the threshold through its module-level name
`split_model_axis`, as the JAX trainer reaches `shard_params_model_axis`:
`parallel.dryrun.tp_threshold` swaps in another one, inside a rank.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from gppvae_tpu_torch.parallel.collectives import gather

MIN_SIZE = 1 << 14  # shard_params_model_axis's default


def _layers(model: nn.Module) -> dict:
    """{weight name: its layer} of the conv and dense layers."""
    return {f"{name}.weight" if name else "weight": m for name, m in model.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))}


def split_layers(model: nn.Module) -> dict:
    """{weight name: layer} of the layers that run split."""
    return {k: m for k, m in _layers(model).items() if getattr(m, "tp_group", None) is not None}


def block(group, t: torch.Tensor) -> torch.Tensor:
    """This model rank's contiguous block of t's first dimension."""
    k = t.shape[0] // group.model_size
    return t[group.model_rank * k:(group.model_rank + 1) * k]


def split_model_axis(model: nn.Module, group, *, min_size: int = MIN_SIZE) -> list[str]:
    """Split `model`'s conv and dense weights by the rule (module docstring)
    over group's model axis, in place; returns the names split. No-op
    without a model axis (group None, a DataGroup, a model axis of 1)."""
    if group is None or group.model_size == 1:
        return []
    layers = _layers(model)
    split, skipped = [], []
    for name, layer in layers.items():
        w = layer.weight
        if w.dim() >= 2 and w.numel() >= min_size:
            if w.shape[0] % group.model_size == 0:
                split.append(name)
            else:
                skipped.append((name, tuple(w.shape)))
    if skipped:
        rows = ", ".join(f"{k} {s}" for k, s in skipped)
        warnings.warn(
            f"split_model_axis: {len(skipped)} weight(s) large enough for tensor "
            f"parallelism have an output dimension not divisible by the model axis "
            f"({group.model_size}) and were REPLICATED instead: {rows}. Resize those "
            "layers (or the model axis) if TP memory/compute savings were expected.",
            stacklevel=2,
        )
    for name in split:
        layer = layers[name]
        layer.weight = nn.Parameter(block(group, layer.weight.detach()).clone())
        layer.tp_group = group
    return split


def shard_mask(model: nn.Module, params) -> list[bool]:
    """For each of `params`: is it the block of a split weight?"""
    ids = {id(m.weight) for m in split_layers(model).values()}
    return [id(p) in ids for p in params]


def gather_state_dict(model: nn.Module) -> dict:
    """model.state_dict() with every split weight whole (collective over the
    model axis: every rank of the row calls it)."""
    layers = split_layers(model)
    return {k: gather(layers[k].tp_group, v, 0) if k in layers else v
            for k, v in model.state_dict().items()}


def load_state_dict(model: nn.Module, state: dict) -> None:
    """Load full weights, narrowing each split one to this rank's block."""
    layers = split_layers(model)
    model.load_state_dict({k: block(layers[k].tp_group, v) if k in layers else v
                           for k, v in state.items()})


def unsplit(model: nn.Module) -> None:
    """Put every split weight back whole, in place (collective over the
    model axis); the layers then run as unsplit ones."""
    for layer in split_layers(model).values():
        layer.weight = nn.Parameter(gather(layer.tp_group, layer.weight, 0))
        layer.tp_group = None
