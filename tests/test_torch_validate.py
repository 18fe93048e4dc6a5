"""validate_torch.py, the port's accuracy protocol, against validate.py.

On the same dataset (the bundled handwritten digits through each package's
build_rotated_digits): the two trivial baselines equal validate.py's own to 1e-6 (the
port's rotation is numpy's, the JAX package's its native library's, and
the images agree to 2e-6); the LIVAE neighbour walk equals validate.py's
`nearest_train` exactly; `digits8x8.npz` equals scikit-learn's
`load_digits()`; a tiny `run_validation` (2 + 2 epochs on the CPU) emits
every JSON line and summary key of validate.py; `plot` renders the
trainer's metrics.jsonl.
"""

import ast
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import gppvae_tpu.train as jax_train_pkg
from gppvae_tpu.data import build_rotated_digits as jax_build
from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.data.rotated_digits import DIGITS_FILE
from _one_thread import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import validate  # noqa: E402
import validate_torch  # noqa: E402

# the JAX package's recorded protocol values (BENCH_r04.json accuracy block)
RECORDED = {"baseline_train_mean": 0.0625583678483963,
            "baseline_per_view_mean": 0.016675693914294243}
# validate.py:155-171
SUMMARY_KEYS = {"verdict", "gppvae_joint_oos_mse", "gppvae_dis_oos_mse", "baseline_train_mean",
                "baseline_per_view_mean", "livae_oos_mse", "cvae_oos_mse",
                "joint_vs_best_baseline", "joint_vs_dis", "joint_vs_cvae", "protocol"}
MODEL_KEYS = {
    "baseline_train_mean": {"oos_mse"}, "baseline_per_view_mean": {"oos_mse"},
    "vae_pretrain": {"recon_mse"}, "livae": {"oos_mse"}, "cvae": {"oos_mse", "recon_mse"},
    "gppvae_dis": {"oos_mse", "oos_mse_epoch0", "recon_mse", "gp_nll_full", "sec_epoch"},
    "gppvae_joint": {"oos_mse", "oos_mse_epoch0", "recon_mse", "gp_nll_full", "sec_epoch"},
}


def test_digits_file_equals_load_digits():
    from sklearn.datasets import load_digits

    want = load_digits()
    with np.load(DIGITS_FILE) as got:
        assert got["images"].dtype == np.uint8 and got["images"].shape == (1797, 8, 8)
        np.testing.assert_array_equal(got["images"], want.images)
        np.testing.assert_array_equal(got["target"], want.target)
    assert os.path.getsize(DIGITS_FILE) < 100_000
    ours = build_rotated_digits("sklearn", num_objects=20, num_views=4, seed=1)
    theirs = jax_build("sklearn", num_objects=20, num_views=4, seed=1)
    np.testing.assert_allclose(ours.images, theirs.images, atol=5e-6)


class _Stop(Exception):
    pass


def _validate_py_baselines(monkeypatch, num_objects):
    """validate.py's own two baseline lines: its run_validation, stopped
    where the first training would start."""
    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(jax_train_pkg, "train_vae", stop)
    lines = []
    with pytest.raises(_Stop):
        validate.run_validation(num_objects=num_objects,
                                emit=lambda s, flush=True: lines.append(json.loads(s)))
    return {rec["model"]: rec["oos_mse"] for rec in lines}


@pytest.mark.parametrize("num_objects", [180, 24])
def test_trivial_baselines_match_validate_py(monkeypatch, num_objects):
    theirs = _validate_py_baselines(monkeypatch, num_objects)
    ds = build_rotated_digits("sklearn", num_objects=num_objects, num_views=16, seed=0)
    base_mean, base_view = validate_torch.trivial_baselines(ds)
    assert abs(base_mean - theirs["baseline_train_mean"]) <= 1e-6
    assert abs(base_view - theirs["baseline_per_view_mean"]) <= 1e-6
    if num_objects == 180:  # the protocol's own size: the recorded values
        assert abs(base_mean - RECORDED["baseline_train_mean"]) <= 1e-6
        assert abs(base_view - RECORDED["baseline_per_view_mean"]) <= 1e-6


def _validate_py_nearest_train(train_mask, Q):
    """validate.py's nested `nearest_train`, compiled from its source over
    the given train_mask and Q."""
    tree = ast.parse((REPO / "validate.py").read_text())
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == "nearest_train"]
    scope = {"train_mask": train_mask, "Q": Q}
    exec(compile(ast.Module([fn], []), "validate.py", "exec"), scope)
    return scope["nearest_train"]


@pytest.mark.parametrize("heldout_per_object,val_fraction", [(1, 0.05), (3, 0.3)])
def test_livae_neighbours_match_validate_py(heldout_per_object, val_fraction):
    ds = build_rotated_digits("synthetic", num_objects=30, num_views=16, seed=0,
                              heldout_per_object=heldout_per_object, val_fraction=val_fraction)
    train_mask = np.zeros(len(ds.images), dtype=bool)
    train_mask[ds.train_idx] = True
    nearest_train = _validate_py_nearest_train(train_mask, ds.num_views)
    ho = ds.heldout_idx
    cells = list(zip(ds.object_ids[ho], ds.view_ids[ho]))
    lo, hi = validate_torch.livae_neighbours(ds)
    np.testing.assert_array_equal(lo, [nearest_train(d, q, -1) for d, q in cells])
    np.testing.assert_array_equal(hi, [nearest_train(d, q, +1) for d, q in cells])
    assert train_mask[lo].all() and train_mask[hi].all()
    assert (ds.object_ids[lo] == ds.object_ids[ho]).all()
    if val_fraction > 0.2:  # some walks pass over a validation or held-out view
        steps = (ds.view_ids[ho] - ds.view_ids[lo]) % ds.num_views
        assert steps.max() > 1
    # an object with no training view is an error, as in validate.py
    orphaned = dataclasses.replace(
        ds, train_idx=ds.train_idx[ds.object_ids[ds.train_idx] != 0])
    with pytest.raises(ValueError, match="no training views"):
        validate_torch.livae_neighbours(orphaned)


@pytest.mark.parametrize("fast", [False, True])
def test_tiny_run_validation_emits_every_line(tmp_path, fast):
    lines = []
    summary = validate_torch.run_validation(
        epochs=2, pretrain=2, num_objects=12, fast=fast, outdir=str(tmp_path), device="cpu",
        emit=lambda s, flush=True: lines.append(json.loads(s)))
    assert [rec.get("model") for rec in lines] == [*MODEL_KEYS, None]
    for rec in lines[:-1]:
        assert set(rec) == {"model", *MODEL_KEYS[rec["model"]]}
        assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float))
    assert lines[-1] == summary and set(summary) == SUMMARY_KEYS
    assert summary["verdict"] in ("PASS", "FAIL")
    assert summary["protocol"] == {"data": "sklearn digits (real)", "num_objects": 12,
                                   "num_views": 16, "pretrain_epochs": 2, "epochs": 2,
                                   "fast": fast}
    assert summary["joint_vs_dis"] == pytest.approx(
        summary["gppvae_joint_oos_mse"] / summary["gppvae_dis_oos_mse"])
    # outdir: each mode's run, with its last epoch's panel (panel_every = epochs - 1)
    for mode in ("dis", "joint"):
        assert {"config.json", "final_state", "final_params.pt", "panel_0001.png"} <= set(
            os.listdir(tmp_path / mode))


def test_validate_torch_cli(monkeypatch, capsys):
    """Same flags as validate.py plus --device (default cuda); a FAIL
    verdict exits 1."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"verdict": seen.pop("_verdict", "PASS")}

    monkeypatch.setattr(validate_torch, "run_validation", fake)
    validate_torch.main([])
    assert seen == dict(epochs=150, pretrain=60, num_objects=180, fast=False, outdir=None,
                        device="cuda")
    validate_torch.main(["--epochs", "3", "--pretrain", "2", "--num_objects", "9", "--fast",
                         "--outdir", "o", "--device", "cpu"])
    assert seen == dict(epochs=3, pretrain=2, num_objects=9, fast=True, outdir="o", device="cpu")
    seen["_verdict"] = "FAIL"
    with pytest.raises(SystemExit) as e:
        validate_torch.main([])
    assert e.value.code == 1


def test_plot_cli(tmp_path):
    """`python -m gppvae_tpu_torch plot <outdir>` renders the history figure
    of a metrics.jsonl (the twin of tests/test_cli.py::test_plot_cli)."""
    rows = [
        {"driver": "train_gppvae[joint]", "epoch": e, "loss": 100.0 - e,
         "recon_term": 90.0 - e, "gp_term": -1.0, "pen_term": 0.1,
         "mse": 0.2 / (e + 1), "oos_mse": 0.3 / (e + 1), "v_sig": 1.0, "v_noise": 0.5,
         "sec_epoch": 0.01}
        for e in range(4)
    ]
    (tmp_path / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    from gppvae_tpu_torch.eval.plots import main, plot_history

    main([str(tmp_path), "--out", str(tmp_path / "h.png")])
    assert os.path.getsize(tmp_path / "h.png") > 1000
    assert plot_history(str(tmp_path / "metrics.jsonl")) == str(tmp_path / "history.png")
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="no records"):
        plot_history(str(tmp_path / "empty.jsonl"))
