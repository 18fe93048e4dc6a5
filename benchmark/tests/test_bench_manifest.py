"""BENCHMARK.json against the benchmark's contract, and the lookup of every
configuration, mix, limit and metric reader by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import ROOT, tiny_tree

from benchmark.harness.manifest import Manifest

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert DOC["paths"] == ["benchmark"]
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) < 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in DOC[k]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
    for c in DOC["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16


def test_entries_have_just_their_keys():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    man = Manifest()
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in DOC["end_to_end"])
    for w in DOC["workloads"]:
        e2e = {m["name"] for m in man.metrics(w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = man.metrics(w["name"], traced=True)
        assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    man = Manifest()
    w = man.workload(cell)
    cfg = man.config(w["config"])
    assert {"data", "model", "train", "precision", "control", "assumed", "reduced"} <= set(cfg)
    assert man.traffic(w["traffic"])["kind"] in ("train", "serve")
    assert man.limits(cell)
    for traced in (False, True):
        for m in man.metrics(cell, traced):
            assert callable(man.reader(m["name"]))


def test_config_files_lie_under_paths():
    for c in DOC["configs"]:
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_a_later_change_adds_a_config_mix_cell_and_metric_as_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric need only
    new files and new entries: the harness finds each by its name."""
    man = tiny_tree(tmp_path)
    doc = json.loads(man.path.read_text())
    bench = tmp_path / "benchmark"
    cfg = json.loads((tmp_path / "benchmark/configs/digits_bf16.json").read_text())
    (bench / "configs" / "digits_dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "serve_views.json").read_text())
    (bench / "traffic" / "serve_dummy.json").write_text(
        json.dumps({**mix, "objects_per_request": [2, 3]}))
    shutil.copy(bench / "limits" / "digits_serve.json", bench / "limits" / "dummy_serve.json")
    (bench / "metrics" / "dummy_requests.py").write_text(
        "def read(run):\n    return float(len(run.latencies)) or None\n")
    doc["configs"].append({"name": "digits_dummy", "source": "https://example.org",
                           "file": "benchmark/configs/digits_dummy.json", "reduced": [],
                           "why": "a dummy"})
    doc["workloads"].append({"name": "dummy_serve", "config": "digits_dummy",
                             "traffic": "serve_dummy", "chips": 1, "why": "a dummy"})
    doc["per_layer"].append({"name": "dummy_requests", "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "Serving", "moves":
                             "serve_images_per_s", "workloads": ["dummy_serve"]})
    man.path.write_text(json.dumps(doc))

    import torch

    from benchmark import run as brun

    man = Manifest(man.path, bench)
    out = brun.run_cell(man, "dummy_serve", 11, 0.2, True, torch.device("cpu"))
    assert out["metrics"]["dummy_requests"]["value"] >= 1
    assert set(out["checks"]) == {"core_gap", "image_gap", "failed_requests"}


OWN_REFERENCE = '''"""The committed reference with the parameters drawn in reverse order and a
FLOP count of its own; USED records what called it."""

from benchmark.reference import gppvae as base

USED = []


def vae_shapes(model, image_shape):
    USED.append("vae_shapes")
    return dict(reversed(base.vae_shapes(model, image_shape).items()))


def vae_flops(model, image_shape):
    USED.append("vae_flops")
    return 1_000_003, 2_000_029


class GPPVAE(base.GPPVAE):
    def __init__(self, cfg, image_shape, vae, gp, precision="exact"):
        USED.append(f"GPPVAE {precision}")
        super().__init__(cfg, image_shape, vae, gp, precision)
'''


@pytest.mark.parametrize("cell", ["faces128_train", "faces128_serve"])
def test_a_configuration_brings_its_own_reference_module(tmp_path, cell):
    """A configuration that names another reference module gets that module's
    parameters (weights.make), model (both comparisons) and FLOP count
    (train_mfu), with no harness edit."""
    import torch

    from benchmark.harness import cells, weights
    from benchmark.reference import gppvae
    from benchmark.yardstick import flops, peaks

    man = tiny_tree(tmp_path)
    bench = tmp_path / "benchmark"
    (bench / "reference" / "own_vae.py").write_text(OWN_REFERENCE)
    cfg_file = bench / "configs" / "faces128_f32.json"
    cfg = json.loads(cfg_file.read_text())
    cfg_file.write_text(json.dumps({**cfg, "reference": "benchmark/reference/own_vae.py"}))
    man = Manifest(man.path, bench)

    w = man.workload(cell)
    cfg, mix = man.config(w["config"]), man.traffic(w["traffic"])
    own = cfg["reference_module"]
    assert own.__file__ == str(bench / "reference" / "own_vae.py")
    run = cells.Run(w, cfg, mix, torch.device("cpu"), 2**31 + 29)
    cells.KINDS[mix["kind"]](run, 0.2, False, 0.0)
    assert {"vae_shapes", "GPPVAE exact"} <= set(own.USED)

    grid, vae0, _ = run.inputs
    names = list(gppvae.vae_shapes(cfg["model"], tuple(grid["images"].shape[1:])))
    assert list(vae0) == names[::-1]
    drawn, _ = weights.make(own, cfg["model"], cfg["train"], grid, run.seed, "cpu")
    plain, _ = weights.make(gppvae, cfg["model"], cfg["train"], grid, run.seed, "cpu")
    assert all(torch.equal(vae0[k], drawn[k]) for k in names)
    assert not torch.equal(vae0[names[0]], plain[names[0]])
    assert run.numbers

    if mix["kind"] == "train":
        s = run.shapes
        work = flops.epoch_flops(1_000_003, 2_000_029, zdim=s["zdim"], n_train=s["n_train"],
                                 n_heldout=s["n_heldout"], batch_size=s["batch_size"],
                                 rank=s["rank"])["total"]
        want = 100.0 * work / (run.window_s / len(run.epochs)) / peaks.STEP_PEAK["float32"]
        assert man.reader("train_mfu")(run) == want
        assert "vae_flops" in own.USED


def test_an_untraced_run_profiles_the_card_where_an_end_to_end_metric_reads_its_trace(
        tmp_path, monkeypatch):
    """digits_serve's end-to-end `serve_card_us_per_image` is read from the
    device's trace: an untraced run profiles a card-only slice of whole
    blocks after the window, and the reader gives busy time per image (on the
    CPU the slice holds no device work, so the reader returns nothing)."""
    import torch

    from benchmark import run as brun
    from benchmark.harness import cells, trace

    man = tiny_tree(tmp_path)
    made = []

    class Run(cells.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(cells, "Run", Run)
    out = brun.run_cell(man, "digits_serve", 13, 0.2, False, torch.device("cpu"))
    r = made[0]
    sizes = man.traffic("serve_views")["objects_per_request"]
    per_block = sum(range(sizes[0], sizes[1] + 1)) * man.config("digits_bf16")["data"][
        "num_views"]
    assert r.card_slice and r.slice is not None and r.slice_images % per_block == 0
    assert "serve_card_us_per_image" not in out["metrics"]
    r.slice = trace.Slice([{"cat": "kernel", "ts": 0.0, "dur": 30.0},
                           {"cat": "kernel", "ts": 10.0, "dur": 40.0}], 1.0, 2)
    r.slice_images = 25
    assert man.reader("serve_card_us_per_image")(r) == pytest.approx(50.0 / 25)

    made.clear()
    brun.run_cell(man, "faces128_serve", 13, 0.2, False, torch.device("cpu"))
    assert not made[0].card_slice and made[0].slice is None
