"""The reader of Phase C's CUDA graph (c_graph_replays_per_step.train) on a
stub tracer: replays per step of the card-only slice, and None where the
program never counted a replay."""

from __future__ import annotations

import types

import pytest
from conftest import ROOT  # noqa: F401

from benchmark.harness import spans
from benchmark.harness.manifest import Manifest
from gppvae_tpu_torch.utils import timers
from gppvae_tpu_torch.utils.timers import Span


def _epoch(out: list, replayed: list[bool]) -> None:
    """A C_minibatch with one C.step per entry; a replayed step credits
    the counter under its C.replay, an eager one has C.forward instead."""
    root = len(out)
    out.append(Span("C_minibatch", -1, 0, 10 * len(replayed), {}))
    for i, r in enumerate(replayed):
        step = len(out)
        out.append(Span("C.step", root, 10 * i, 10 * i + 9, {}))
        out.append(Span("C.replay", step, 10 * i, 10 * i + 2, {"C.graph_replay": 1}) if r
                   else Span("C.forward", step, 10 * i, 10 * i + 3, {}))


class _Run:
    """What the span readers read of a run: its two slices' units."""

    def __init__(self, card_epochs: int):
        self.slice = types.SimpleNamespace(units=card_epochs)
        self.host_slice = types.SimpleNamespace(units=1)


@pytest.mark.parametrize("card,want", [
    ([[True] * 4, [True] * 4], 1.0),          # every step a replay
    ([[False, False, True, True]], 0.5),      # warm-up and capture in the slice
    ([[False] * 3], 0.0),                      # eager steps only
])
def test_the_reader_reads_replays_per_step_of_the_card_only_slice(monkeypatch, card, want):
    recorded: list = []
    _epoch(recorded, [False] * 5)  # an older epoch, not in the slice
    for replayed in card:
        _epoch(recorded, replayed)
    _epoch(recorded, [True, False])  # the host slice's epoch
    run = _Run(len(card))
    spans._TAKEN[run] = recorded
    monkeypatch.setattr(timers.TRACER, "counts", {"C.graph_replay": 99})
    assert Manifest().reader("c_graph_replays_per_step.train")(run) == pytest.approx(want)


def test_the_reader_reads_none_without_the_counter_or_the_tracer(monkeypatch):
    reader = Manifest().reader("c_graph_replays_per_step.train")
    run = _Run(1)
    spans._TAKEN[run] = []
    _epoch(spans._TAKEN[run], [False, False])
    _epoch(spans._TAKEN[run], [False])
    # a program that never replays a step (a version before the graphs)
    monkeypatch.setattr(timers.TRACER, "counts", {"host_sync": 4})
    assert reader(run) is None
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert reader(run) is None
