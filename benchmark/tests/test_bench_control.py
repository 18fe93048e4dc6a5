"""The comparison fails what it must: the control (the reference one
precision step below the configuration, put in the program's place) and each
fault planted under the timed path come out not correct under the committed
limits, at a tiny size.

The float8 control and the faults run here on the CPU; the TF32 control
needs the card's tensor cores (the `cuda` tests)."""

from __future__ import annotations

import pytest
import torch
from conftest import ROOT  # noqa: F401

from benchmark import run
from benchmark.harness import cells, checks, faults

SEED = 2**31 + 91
TRAIN_CELLS = ("faces128_train",)
SERVE_CELLS = ("digits_serve", "faces128_serve")


def _control_passes(manifest, name: str, device) -> bool:
    """Whether the control, judged as the program is, would be correct."""
    cell = manifest.workload(name)
    cfg, mix = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    r = cells.Run(cell, cfg, mix, device, SEED)
    cells.KINDS[mix["kind"]](r, 0.2, False, 0.0)
    number = checks.training_numbers if mix["kind"] == "train" else checks.serving_numbers
    ok, _ = checks.judge(number(cells.reference(r, cfg["control"]), r.ref),
                         manifest.limits(name))
    return ok


@pytest.mark.parametrize("cell", ["digits_serve"])
def test_the_float8_control_is_not_correct(tiny, cell):
    assert not _control_passes(tiny, cell, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["faces128_train", "faces128_serve"])
def test_the_tf32_control_is_not_correct(tiny, card, cell):
    assert not _control_passes(tiny, cell, card)


def _run_with(manifest, name: str, fault: str | None, seconds: float = 0.2):
    plant = {**faults.TRAINING, **faults.SERVING}[fault] if fault else None
    return run.run_cell(manifest, name, SEED, seconds, False, torch.device("cpu"), fault=plant)


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_training_fault_is_not_correct(tiny, cell, fault):
    assert not _run_with(tiny, cell, fault)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_serving_fault_is_not_correct(tiny, cell, fault):
    assert not _run_with(tiny, cell, fault)["correct"]


@pytest.mark.parametrize("cell", ["faces128_train", "faces128_serve"])
def test_the_same_run_without_a_fault_is_within_its_limits(tiny, cell):
    """(update_gap as in test_bench_reference.py: at this size it reads
    the round-off of W's normalised directions; the serving window as there
    too.)"""
    seconds = 1.0 if cell in SERVE_CELLS else 0.2
    for name, row in _run_with(tiny, cell, None, seconds)["checks"].items():
        assert row["value"] <= (1e-2 if name == "update_gap" else row["limit"]), (name, row)


def test_the_first_loss_gap_reads_the_first_step_alone():
    """A later step's loss that strays (Adam's first move of an element
    whose gradient rounding turned) moves step_loss_gap, not first_loss_gap."""
    coeffs = {"value": torch.tensor(7.0),
              **{k: torch.ones(3) for k in ("dZ", "dV", "dlog_vs", "dlog_vn")}}
    leaves = {"a": torch.ones(4), "b": torch.full((2,), 2.0)}
    ref = {"Z0": torch.ones(5), "coeffs": coeffs, "losses": [100.0, 90.0, 80.0],
           "grads": leaves, "change": leaves, "y_pred": torch.zeros(2)}
    prog = {**ref, "losses": [100.0001, 90.0, 80.008]}
    numbers = checks.training_numbers(prog, ref)
    assert numbers["first_loss_gap"] == pytest.approx(1e-6)
    assert numbers["step_loss_gap"] == pytest.approx(1e-4)
