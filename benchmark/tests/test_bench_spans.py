"""The readers of the program's spans and counters (harness/spans.py and the
metrics that use it), the idle split by span, the tracer wrappers against a
program that has no tracer, and benchmark/split.py at a tiny size."""

from __future__ import annotations

import json
import types

import pytest
import torch
from conftest import ROOT, tiny_tree

from benchmark import run as brun
from benchmark import split
from benchmark.harness import spans
from benchmark.harness.manifest import Manifest
from gppvae_tpu_torch.utils.timers import Span

TRAIN_READERS = {"c_sync_wait_ms.train": 0.5, "host_syncs_per_step.train": 2.0}
SERVE_READERS = {"serve_gp_ms.serve": 0.5, "serve_decode_ms.serve": 1.5,
                 "serve_wait_ms.serve": 4.0}
MS = 1_000_000


class _Run:
    """What the span readers read of a run: its two slices' units."""

    def __init__(self, units: int, host_units: int | None):
        self.slice = types.SimpleNamespace(units=units)
        self.host_slice = None if host_units is None else types.SimpleNamespace(units=host_units)


def _epoch(out: list, t: int, steps: int) -> int:
    """One epoch's spans from t (ns) on: the phase and `steps` steps of 8
    ms (forward 2, backward 3, optim 1.5 of which two guard reads of 0.25),
    then a read of 1 ms at the root. Returns the end."""
    phase = len(out)
    out.append(None)
    start = t
    for _ in range(steps):
        step = len(out)
        out.append(None)
        s0 = t
        out.append(Span("C.forward", step, t, t + 2 * MS, {}))
        out.append(Span("C.backward", step, t + 2 * MS, t + 5 * MS, {}))
        opt = len(out)
        out.append(None)
        out.append(Span("sync.guard", opt, t + 5 * MS, t + 5 * MS + MS // 4, {"host_sync": 1}))
        out.append(Span("sync.guard", opt, t + 6 * MS, t + 6 * MS + MS // 4, {"host_sync": 1}))
        out[opt] = Span("C.optim", step, t + 5 * MS, t + 6 * MS + MS // 2, {})
        t += 8 * MS
        out[step] = Span("C.step", phase, s0, t, {})
    out[phase] = Span("C_minibatch", -1, start, t, {})
    out.append(Span("sync.metrics", -1, t, t + MS, {"host_sync": 1}))
    return t + MS


def _requests(out: list, t: int, n: int) -> int:
    """n requests: serve.predict of 2 ms (gp 0.5, decode 1.5), 4 ms apart."""
    for _ in range(n):
        root = len(out)
        out.append(Span("serve.predict", -1, t, t + 2 * MS, {}))
        out.append(Span("serve.gp", root, t, t + MS // 2, {}))
        out.append(Span("serve.decode", root, t + MS // 2, t + 2 * MS, {}))
        t += 6 * MS
    return t


def _read(name: str, run) -> float | None:
    return Manifest().reader(name)(run)


def test_the_span_readers_read_the_card_only_slice():
    """Two card-only epochs (2 steps each) after an older one, then the host
    slice's epoch, whose steps are longer: only the first two are read."""
    recorded: list = []
    t = _epoch(recorded, 0, 5)
    for _ in range(2):
        t = _epoch(recorded, t, 2)
    host: list = []
    _epoch(host, 0, 3)
    shift = len(recorded)
    recorded += [s._replace(parent=s.parent + shift if s.parent >= 0 else -1,
                            start_ns=s.start_ns + t, end_ns=s.end_ns + t * 2)
                 for s in host]
    run = _Run(2, 1)
    spans._TAKEN[run] = recorded
    for name, want in TRAIN_READERS.items():
        assert _read(name, run) == pytest.approx(want), name
    serve = _Run(3, 1)
    spans._TAKEN[serve] = []
    _requests(spans._TAKEN[serve], 0, 5)
    for name, want in SERVE_READERS.items():
        assert _read(name, serve) == pytest.approx(want), name


@pytest.mark.parametrize("recorded", [None, []])
def test_without_spans_every_reader_reads_none(recorded):
    run = _Run(3, 1)
    spans._TAKEN[run] = recorded
    for name in (*TRAIN_READERS, *SERVE_READERS):
        assert _read(name, run) is None, name


def test_too_few_units_read_none():
    run = _Run(3, 1)
    spans._TAKEN[run] = []
    _epoch(spans._TAKEN[run], 0, 2)
    assert _read("c_sync_wait_ms.train", run) is None


def test_the_wrappers_do_nothing_without_the_programs_tracer(monkeypatch):
    import gppvae_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "timers", types.ModuleType("timers"))
    assert spans.tracer() is None
    spans.set_tracing(True)
    run = _Run(1, 1)
    assert spans.taken(run) is None
    for name in (*TRAIN_READERS, *SERVE_READERS):
        assert _read(name, run) is None, name
    assert split.main(["--workload", "faces128_train", "--seed", "1", "--device", "cpu"]) == 2


def _event(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_idle_by_span_gives_each_gap_to_the_innermost_span_covering_most():
    """µs from the first event: kernels at 0–10, 30–40, 70–80; the card
    idles 10–30 (C.forward covers 15 of it, inside C.step), 40–70
    (sync.guard covers 14 of it: C.step's) and 80–100, the slice's end."""
    events = [_event("kernel", "k", 0, 10), _event("kernel", "k", 30, 10),
              _event("gpu_memcpy", "copy", 70, 10),
              _event("cpu_op", "aten::mm", 0, 5),
              _event("user_annotation", "C.step", 0, 60),
              _event("user_annotation", "C.forward", 5, 20),
              _event("user_annotation", "sync.guard", 46, 14),
              _event("user_annotation", "Optimizer.step#Adam.step", 12, 16),  # not ours
              _event("gpu_user_annotation", "C.step", 0, 60)]
    out = spans.idle_by_span(events, 100e-6, {"C.step", "C.forward", "sync.guard"})
    got = dict(out["spans"])
    assert got == pytest.approx({"C.forward": 20e-6, "C.step": 30e-6,
                                 "outside the program": 20e-6})
    assert out["idle_s"] == pytest.approx(70e-6)
    assert out["under_spans_s"] == pytest.approx(50e-6)


def test_a_tiny_traced_run_reads_every_new_metric(tmp_path):
    man = tiny_tree(tmp_path)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in ("faces128_train", "faces128_serve"):
        out = brun.run_cell(man, cell, 2**31 + 13, 0.2, True, torch.device("cpu"))
        assert out["correct"]
        listed = {m["name"] for m in doc["per_layer"] if cell in m.get("workloads", ())
                  and m["name"] in (*TRAIN_READERS, *SERVE_READERS)}
        assert listed
        assert listed <= set(out["metrics"]), listed - set(out["metrics"])
    assert out["metrics"]["serve_wait_ms.serve"]["value"] > 0


@pytest.mark.parametrize("cell", ["faces128_train", "digits_serve"])
def test_split_runs_a_cell_at_a_tiny_size(tmp_path, capsys, cell):
    man = tiny_tree(tmp_path)
    assert split.main(["--workload", cell, "--seed", str(2**31 + 5), "--units", "1",
                       "--device", "cpu", "--out", str(tmp_path / "s.json")], manifest=man) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out == json.loads((tmp_path / "s.json").read_text())
    assert out["span_cost_ns"]["on"] > 0 and out["idle"]["idle_s"] >= 0
    if cell == "faces128_train":
        traced = out["traced"][0]
        # a Phase C step makes no host sync since the guarded Adam decides on the card
        assert traced["host_syncs_per_step"] == 0 and traced["steps"] >= 1
        assert 0.5 < traced["steps_over_phase"] <= 1.0
        assert {"setup", "setup.model", "setup.gp", "setup.data", "setup.object_kernel",
                "setup.loop"} <= set(out["setup"])
        assert out["setup_over_program_part"] <= 1.0
    else:
        assert {"fold", "fold.encode", "fold.factorize", "fold.core"} <= set(out["setup"])
        assert out["traced"]["requests"] == 5
        t = out["traced"]
        assert t["gp_ms"] + t["decode_ms"] <= t["predict_ms"] <= t["request_ms"]
