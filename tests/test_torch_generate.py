"""The port's generate and serve CLIs, its checkpoint format and PNG panels,
and the request / observation parsers against the JAX package's.

Runs at the golden size (10 objects × 8 views, 32², zdim 6): two runs of
the port's own trainer on the CPU (`--device cpu`), one float32 with the
linear kernel, one bfloat16 with a float32 polish epoch, rbf-nystrom and an
extra object effect; each is exported with `generate --export_server` and
served with `serve`. Every JSON line carries the keys the JAX CLI prints
(gppvae_tpu/eval/generate.py, serving.py). Tolerances: the held-out MSE of
`generate` equals the trainer's last oos_mse (rel 1e-6, the same f32
computation); served images equal the library's (atol 1e-7) and
generate's held-out images (abs 1e-5); two observes equal one over both
batches (M rtol 1e-4, atol 1e-5); PNG pixels equal exactly.
"""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from gppvae_tpu.data.build_cli import main as jax_build_data
from gppvae_tpu.eval.panels import save_panel as jax_save_panel
from gppvae_tpu.eval.serving import _load_observation_npz as jax_load_obs
from gppvae_tpu.eval.serving import _parse_requests as jax_parse
from gppvae_tpu_torch.checkpoint import FORMAT_VERSION, CheckpointFormatError, load_tree, save_tree
from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.eval import generate, serving
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.train import train_gppvae
from _one_thread import one_thread  # noqa: F401

GOLDEN_CLI = ["--data", "synthetic", "--num_objects", "10", "--num_views", "8",
              "--zdim", "6", "--bs", "16", "--enc_features", "8,16",
              "--dec_features", "16,8", "--seed", "7", "--device", "cpu",
              "--xdim", "4", "--view_freqs", "2"]
RUNS = {
    "f32": ["--epochs", "1"],
    "bf16_polish": ["--epochs", "2", "--dtype", "bfloat16", "--dec_upsample", "subpixel",
                    "--polish_epochs", "1", "--object_kernel", "rbf-nystrom",
                    "--rff_features", "12", "--nystrom_rank", "5", "--extra_effects", "object"],
}
# the keys of the JAX CLI's JSON lines
KEYS = {
    "heldout": {"heldout_mse", "n_heldout"},
    "export": {"server_state", "rank", "zdim"},
    "var": {"n_requests", "state", "posterior_var", "latency_s", "panel", "npz"},
    "joint": {"n_requests", "state", "samples_per_request", "joint", "latency_s", "panel", "npz"},
    "throughput": {"n_requests", "state", "latency_s", "panel", "npz", "repeat",
                   "repeat_latency_s_min", "repeat_latency_s_median", "images_per_sec",
                   "sustained_chain", "sustained_latency_s_min", "sustained_images_per_sec"},
    "observe": {"observed", "fold_s", "save_state"},
    "ready": {"ready", "grid", "max_batch", "commands"},
    "line": {"line", "n_requests", "latency_s", "posterior_var", "npz"},
    "line_observe": {"line", "observed", "fold_s"},
    "line_save": {"line", "saved"},
    "line_error": {"line", "error"},
}


def _cli(fn, argv) -> list[dict]:
    """Run a CLI main; its JSON stdout lines, parsed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run: its outdir, history, final_params.pt and exported .srv."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name, flags in RUNS.items():
        d = root / name
        res = train_gppvae.main([*GOLDEN_CLI, *flags, "--outdir", str(d)])
        srv = str(d / "m.srv")
        (export,) = _cli(generate.main, ["--state", str(d / "final_params.pt"), "--device",
                                         "cpu", "--export_server", srv])
        out[name] = dict(dir=d, history=res.history, srv=srv, export=export,
                         ds=res.data, final=str(d / "final_params.pt"))
    return out


def _heldout_pairs(run, n=None):
    d, q = run["ds"]["d_ho"].tolist(), run["ds"]["q_ho"].tolist()
    return ",".join(f"{a}:{b}" for a, b in list(zip(d, q))[:n])


def _serve(run, *flags, outdir):
    return _cli(serving.main, ["--state", run["srv"], "--device", "cpu", *flags,
                               "--outdir", str(outdir)])


def _loaded(run):
    state, meta = serving.load_server_state(run["srv"])
    model = serving._model_from_meta(meta, state.vae_params, "cpu")
    return state, meta, model, serving.x_map_from_meta(meta, state.X.shape[1])


def test_generate_heldout_mse_equals_the_trainers_last(runs, tmp_path):
    run = runs["f32"]
    (rec,) = _cli(generate.main, ["--state", run["final"], "--device", "cpu",
                                  "--outdir", str(tmp_path)])
    assert set(rec) == KEYS["heldout"] and rec["n_heldout"] == 10
    assert rec["heldout_mse"] == pytest.approx(run["history"][-1]["oos_mse"], rel=1e-6)
    assert (tmp_path / "oos_panel.png").is_file()


@pytest.mark.parametrize("name", list(RUNS))
def test_export_server_records_the_run(runs, name):
    """The artifact's meta holds the run's architecture, kernel and compute
    dtype; its tree carries the run's RFF draws and Nyström landmarks."""
    run = runs[name]
    assert set(run["export"]) == KEYS["export"]
    state, meta = serving.load_server_state(run["srv"])
    final = torch.load(run["final"], weights_only=True)
    assert meta["zdim"] == 6 and meta["image_shape"] == [32, 32, 1]
    assert meta["enc_features"] == [8, 16] and meta["dec_features"] == [16, 8]
    if name == "f32":
        assert run["export"]["rank"] == 4 * 5 and meta["object_kernel"] == "linear"
        assert "rff_draws" not in meta and "nystrom_idx" not in meta
    else:
        assert run["export"]["rank"] == 5 * 5 + 4  # landmarks × view rank + object effect
        assert meta["compute_dtype"] == "bfloat16" and meta["dec_upsample"] == "subpixel"
        assert meta["extra_effects"] == ["object"] and state.v_sig.shape == (2,)
        ok = final["object_kernel"]
        assert torch.equal(meta["nystrom_idx"], ok["nystrom_idx"])
        assert torch.equal(meta["rff_draws"][0], ok["omega"])
        assert torch.equal(meta["rff_draws"][1], ok["phase"])
    for k, v in final["vae"].items():
        assert torch.equal(state.vae_params[k], v), k


def test_serving_dtype_follows_the_run_not_the_polish_tail(runs, tmp_path):
    """A bfloat16 run with a float32 polish tail is generated and served in
    bfloat16, as the JAX package does (generate.py:77-84, serving.py:
    1262-1270); load_final, which resumes the trainer's state, builds the
    float32 it ended in."""
    run = runs["bf16_polish"]
    assert train_gppvae.load_final(str(run["dir"])).model.dtype == torch.float32
    state, meta, model, x_map = _loaded(run)
    assert model.dtype == torch.bfloat16
    final = torch.load(run["final"], weights_only=True)
    side = json.loads((run["dir"] / "config.json").read_text())
    gmodel, _ = generate._model_and_xmap(final, _dataset(), **{
        k: side[k] for k in ("zdim", "enc_features", "dec_features", "object_kernel",
                             "rff_lengthscale", "dec_upsample", "compute_dtype")})
    assert gmodel.dtype == torch.bfloat16

    (rec,) = _serve(run, "--requests", _heldout_pairs(run), outdir=tmp_path)
    served = np.load(rec["npz"])["images"]
    extra = tuple(meta["extra_effects"])
    d, q = run["ds"]["d_ho"], run["ds"]["q_ho"]
    bf16 = serving.predict_images(model, state, d, q, x_map=x_map, extra_effects=extra)
    np.testing.assert_allclose(served, bf16.numpy(), rtol=0, atol=1e-7)
    model.dtype = torch.float32
    f32 = serving.predict_images(model, state, d, q, x_map=x_map, extra_effects=extra)
    assert float(np.abs(served - f32.numpy()).max()) > 1e-6  # bf16 rounding shows


def _dataset() -> GridDataset:
    """The grid both runs trained on (GOLDEN_CLI)."""
    return build_dataset_from_flag("synthetic", 10, 8, 7)


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_cli_answers_from_the_artifact(runs, name, tmp_path):
    """--requests with --var, --sample 3 --joint and the throughput modes:
    the JAX CLI's keys, generate's held-out images, finite draws of shape
    (n, K, H, W, C) and positive rates."""
    run = runs[name]
    (rec,) = _serve(run, "--requests", _heldout_pairs(run), "--var", outdir=tmp_path / "v")
    assert set(rec) == KEYS["var"] and rec["n_requests"] == 10
    assert all(v > 0 for v in rec["posterior_var"])
    served = np.load(rec["npz"])
    assert served["images"].shape == (10, 32, 32, 1) and served["objects"].dtype == np.int32
    final = torch.load(run["final"], weights_only=True)
    side = json.loads((run["dir"] / "config.json").read_text())
    y_gen, _ = generate.generate_heldout(final, _dataset(), **{
        k: side[k] for k in ("zdim", "enc_features", "dec_features", "object_kernel",
                             "rff_lengthscale", "extra_effects", "dec_upsample",
                             "compute_dtype")})
    assert float(np.abs(served["images"] - y_gen).max()) <= 1e-5
    assert (tmp_path / "v" / "served.png").is_file()

    (rec,) = _serve(run, "--requests", "3:2,5:0,3:2", "--sample", "3", "--joint",
                    outdir=tmp_path / "j")
    assert set(rec) == KEYS["joint"] and rec["joint"] is True
    draws = np.load(rec["npz"])["images"]
    assert draws.shape == (3, 3, 32, 32, 1) and np.isfinite(draws).all()

    (rec,) = _serve(run, "--requests", "3:2,5:0", "--repeat", "2", "--sustained", "3",
                    outdir=tmp_path / "t")
    assert set(rec) == KEYS["throughput"]
    assert rec["images_per_sec"] > 0 and rec["sustained_images_per_sec"] > 0
    assert rec["repeat_latency_s_min"] <= rec["repeat_latency_s_median"]


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_cli_observe(runs, name, tmp_path):
    """--observe folds an npz into the artifact: the observed cells' variance
    does not rise; observe then answer in one call; two observes equal one
    over both batches."""
    run = runs[name]
    ds = _dataset()
    ho = ds.heldout_idx
    obs = {}
    for part, rows in (("a", ho[:6]), ("b", ho[6:]), ("ab", ho)):
        obs[part] = str(tmp_path / f"{part}.npz")
        np.savez_compressed(obs[part], images=ds.images[rows], objects=ds.object_ids[rows],
                            views=ds.view_ids[rows])
    req = _heldout_pairs(run)
    (before,) = _serve(run, "--requests", req, "--var", outdir=tmp_path / "0")
    rec, after = _serve(run, "--observe", obs["ab"], "--save_state", str(tmp_path / "ab.srv"),
                        "--requests", req, "--var", outdir=tmp_path / "1")
    assert set(rec) == KEYS["observe"] and rec["observed"] == 10
    assert all(b <= a + 1e-6 for a, b in zip(before["posterior_var"], after["posterior_var"]))
    assert sum(after["posterior_var"]) < sum(before["posterior_var"])

    a2 = str(tmp_path / "a.srv")
    assert len(_serve(run, "--observe", obs["a"], "--save_state", a2, outdir=tmp_path)) == 1
    _cli(serving.main, ["--state", a2, "--device", "cpu", "--observe", obs["b"],
                        "--save_state", str(tmp_path / "a_b.srv")])
    two, meta = serving.load_server_state(str(tmp_path / "a_b.srv"))
    one, _ = serving.load_server_state(str(tmp_path / "ab.srv"))
    np.testing.assert_allclose(two.core.G.numpy(), one.core.G.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(two.core.M.numpy(), one.core.M.numpy(), rtol=1e-4, atol=1e-5)
    orig = serving.load_server_state(run["srv"])[1]
    assert {k: v for k, v in meta.items() if not isinstance(v, (tuple, torch.Tensor))} == \
        {k: v for k, v in orig.items() if not isinstance(v, (tuple, torch.Tensor))}
    assert ("rff_draws" in meta) == ("rff_draws" in orig)  # the tensors travel too


def test_serve_stdin_loop(runs, tmp_path):
    """Request lines past --max_batch run in chunks and equal the direct
    predict_images; observe lines fold in chunks and equal the library
    observe; save persists; blank lines are skipped; malformed, out-of-grid,
    missing and corrupt-file lines get an error reply and the loop goes on."""
    run = runs["bf16_polish"]
    ds = _dataset()
    obs = str(tmp_path / "obs.npz")
    rows = ds.heldout_idx[:5]
    np.savez_compressed(obs, images=ds.images[rows], objects=ds.object_ids[rows],
                        views=ds.view_ids[rows])
    bad_zip = tmp_path / "bad.npz"
    bad_zip.write_bytes(b"PK\x03\x04 not a zip")
    saved = str(tmp_path / "saved.srv")
    lines = ["0:0,1:1,2:2,3:3,4:4", "", "3", "99:0", f"observe {obs}", "0:0",
             f"save {saved}", "observe /nonexistent.npz", f"observe {bad_zip}", "1:1"]
    old = sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        out = _serve(run, "--stdin", "--max_batch", "2", outdir=tmp_path / "loop")
    finally:
        sys.stdin = old
    assert set(out[0]) == KEYS["ready"] and out[0]["max_batch"] == 2 and out[0]["grid"] == [10, 8]
    by_line = {r["line"]: r for r in out[1:]}
    assert sorted(by_line) == [0, 2, 3, 4, 5, 6, 7, 8, 9]
    for k, kind in ((0, "line"), (2, "line_error"), (3, "line_error"), (4, "line_observe"),
                    (5, "line"), (6, "line_save"), (7, "line_error"), (8, "line_error"),
                    (9, "line")):
        assert set(by_line[k]) == KEYS[kind], k
    assert "want object:view" in by_line[2]["error"] and "outside" in by_line[3]["error"]
    assert by_line[4]["observed"] == 5

    state, meta, model, x_map = _loaded(run)
    extra = tuple(meta["extra_effects"])
    first = np.load(by_line[0]["npz"])
    y, v = serving.predict_images(model, state, torch.arange(5), torch.arange(5), x_map=x_map,
                                  extra_effects=extra, return_var=True)
    np.testing.assert_allclose(first["images"], y.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(first["posterior_var"], v.numpy(), rtol=1e-6)
    direct = state
    for s0 in (0, 2, 4):
        r = rows[s0:s0 + 2]
        direct = serving.observe(model, direct, torch.from_numpy(ds.images[r]),
                                 torch.as_tensor(ds.object_ids[r], dtype=torch.int64),
                                 torch.as_tensor(ds.view_ids[r], dtype=torch.int64),
                                 x_map=x_map, extra_effects=extra)
    back, back_meta = serving.load_server_state(saved)
    for a, b in zip(back.core, direct.core):
        assert torch.equal(a, b)
    assert torch.equal(back_meta["rff_draws"][0], meta["rff_draws"][0])
    assert by_line[5]["posterior_var"][0] < by_line[0]["posterior_var"][0]


@pytest.mark.parametrize("flags,match", [
    (["--stdin", "--sample", "4"], "sample"),
    (["--stdin", "--repeat", "2"], "repeat"),
    (["--stdin", "--sustained", "2"], "sustained"),
    (["--requests", "3:2", "--sample", "4", "--repeat", "2"], "sample"),
    (["--requests", "3:2", "--sample", "4", "--sustained", "2"], "sustained"),
    (["--requests", "3:2", "--joint"], "joint"),
    (["--requests", "3:2", "--sample", "2", "--var"], "pass one"),
    (["--observe", "x.npz"], "save_state"),
    (["--observe", "x.npz", "--save_state", "y", "--stdin"], "separate runs"),
    ([], "exactly one of --requests or --stdin"),
    (["--requests", "3:2", "--stdin"], "exactly one of --requests or --stdin"),
    (["--stdin", "--max_batch", "0"], "max_batch"),
    (["--requests", "99:0"], "outside"),
    (["--requests", "3:2:5"], "want object:view"),
])
def test_serve_cli_refuses_flag_combinations(runs, flags, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        _serve(runs["f32"], *flags, outdir=tmp_path)


@pytest.mark.parametrize("flag", ["--exe", "--export_exe"])
def test_compiled_program_flags_are_not_ported(runs, flag, tmp_path):
    """The name dates from when both flags raised NotImplementedError. Now
    each is held to the refusals that no other test makes: --exe of a path
    that holds no artifact fails by the sidecar's name, and neither flag
    goes together with the other surface's."""
    if flag == "--exe":
        with pytest.raises(FileNotFoundError, match="compiled-program sidecar .*x.meta.json"):
            serving.main(["--exe", str(tmp_path / "x"), "--device", "cpu", "--requests", "1:1"])
        with pytest.raises(SystemExit, match="exactly one of --state or --exe"):
            serving.main(["--state", runs["f32"]["srv"], "--device", "cpu", "--exe", "x"])
    else:
        with pytest.raises(SystemExit, match="--export_exe needs --state"):
            serving.main(["--exe", str(tmp_path / "x"), "--device", "cpu", "--export_exe", "y"])


@pytest.fixture(scope="module")
def exes(runs):
    """Each run's exported program, through `serve --state --export_exe`."""
    out = {}
    for name, run in runs.items():
        exe = str(run["dir"] / "m.exe")
        (rec,) = _cli(serving.main, ["--state", run["srv"], "--device", "cpu",
                                     "--export_exe", exe])
        out[name] = dict(exe=exe, meta=rec)
    return out


def _serve_exe(exe, *flags, outdir):
    return _cli(serving.main, ["--exe", exe["exe"], "--device", "cpu", *flags,
                               "--outdir", str(outdir)])


def _same(ours, theirs, name):
    """An --exe reply against the --state reply: the loaded graph runs the
    eager path's ATen ops, but a batch of one may reach another BLAS or
    convolution routine, so float32 images agree to 1e-6, not to the bit;
    in a bfloat16 run such a last-bit difference can flip one bfloat16
    rounding in the decoder (one ulp of a value below 1 is 4e-3)."""
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 if name == "f32" else 4e-3)


def _same_var(ours, theirs):
    assert (ours is None) == (theirs is None)
    if ours is not None:  # printed to 6 decimals
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-6)


EXE_KEYS = {
    "export": {"export_exe", "format", "grid", "image_shape", "zdim", "platforms",
               "entry_points", "core_npz", "bytes", "total_bytes", "torch", "compute_dtype"},
    "mean": {"n_requests", "exe", "entry", "latency_s", "panel", "npz"},
    "observe": {"observed", "fold_s", "save_core"},
}


@pytest.mark.parametrize("name", list(RUNS))
def test_export_exe_then_exe_equals_state(runs, exes, name, tmp_path):
    """`serve --state m.srv --export_exe m.exe` writes the eight programs, the
    core npz and the meta; `serve --exe m.exe` then returns what `serve
    --state` returns for the same flags and seed (see _same): means
    (with and without --var), --sample K, --sample K --joint, at one request
    and at several, in the run's compute dtype; the throughput modes run on
    the mean program."""
    run, exe = runs[name], exes[name]
    meta = exe["meta"]
    assert set(meta) == EXE_KEYS["export"] and meta["format"] == "torch.export.v1"
    assert meta["compute_dtype"] == ("float32" if name == "f32" else "bfloat16")
    assert meta["platforms"] == ["cpu"] and meta["grid"] == [10, 8] and meta["zdim"] == 6
    files = sorted(p.name for p in run["dir"].iterdir() if p.name.startswith("m.exe"))
    assert files == sorted(["m.exe", "m.exe.var", "m.exe.sample", "m.exe.joint", "m.exe.observe",
                            "m.exe.sample_core", "m.exe.joint_core", "m.exe.predict",
                            "m.exe.core.npz", "m.exe.meta.json"])
    several = _heldout_pairs(run)
    for i, (req, flags, entry) in enumerate([
            (several, ["--var"], "var"), (several, [], "mean"), ("3:2", [], "mean"),
            ("3:2,5:0,3:2", ["--sample", "3", "--seed", "4"], "sample"),
            ("3:2,5:0,3:2", ["--sample", "3", "--joint", "--seed", "4"], "sample_joint"),
            ("3:2", ["--sample", "1", "--joint"], "sample_joint")]):
        (theirs,) = _serve(run, "--requests", req, *flags, outdir=tmp_path / f"s{i}")
        (ours,) = _serve_exe(exe, "--requests", req, *flags, outdir=tmp_path / f"e{i}")
        assert ours["entry"] == entry and ours["exe"] == exe["exe"]
        assert set(ours) - {"exe", "entry"} == set(theirs) - {"state"}
        a, b = np.load(ours["npz"]), np.load(theirs["npz"])
        _same(a["images"], b["images"], name)
        np.testing.assert_array_equal(a["objects"], b["objects"])
        assert a["objects"].dtype == np.int32 and a["images"].dtype == np.float32
        _same_var(ours.get("posterior_var"), theirs.get("posterior_var"))
        assert (tmp_path / f"e{i}" / "served.png").is_file()
    (rec,) = _serve_exe(exe, "--requests", "3:2,5:0", "--repeat", "2", "--sustained", "3",
                        outdir=tmp_path / "t")
    assert set(rec) == (KEYS["throughput"] - {"state"}) | {"exe", "entry"}
    assert rec["entry"] == "mean" and rec["images_per_sec"] > 0
    assert rec["sustained_images_per_sec"] > 0


@pytest.mark.parametrize("name", list(RUNS))
def test_exe_observe_save_core_then_core(runs, exes, name, tmp_path):
    """--exe --observe --save_core folds an npz into the exported initial
    core and keeps it as a plain npz; --core serves from it: means,
    variances and draws equal `serve --state` on the state that --observe
    --save_state wrote; a second --observe on --core equals one over both."""
    run, exe = runs[name], exes[name]
    ds = _dataset()
    ho = ds.heldout_idx
    obs = {}
    for part, rows in (("a", ho[:6]), ("b", ho[6:]), ("ab", ho)):
        obs[part] = str(tmp_path / f"{part}.npz")
        np.savez_compressed(obs[part], images=ds.images[rows], objects=ds.object_ids[rows],
                            views=ds.view_ids[rows])
    req = _heldout_pairs(run)
    core_ab = str(tmp_path / "ab.core.npz")
    rec, after = _serve_exe(exe, "--observe", obs["ab"], "--save_core", core_ab,
                            "--requests", req, "--var", outdir=tmp_path / "e1")
    assert set(rec) == EXE_KEYS["observe"] and rec["observed"] == 10
    assert after["entry"] == "predict_core"
    _, theirs = _serve(run, "--observe", obs["ab"], "--save_state", str(tmp_path / "ab.srv"),
                       "--requests", req, "--var", outdir=tmp_path / "s1")
    _same_var(after["posterior_var"], theirs["posterior_var"])
    _same(np.load(after["npz"])["images"], np.load(theirs["npz"])["images"], name)
    state_ab, _ = serving.load_server_state(str(tmp_path / "ab.srv"))
    with np.load(core_ab) as f:
        assert sorted(f.files) == ["G", "Lb", "M", "v_noise"]
        for k in f.files:
            np.testing.assert_allclose(f[k], getattr(state_ab.core, k).numpy(), rtol=1e-5,
                                       atol=1e-6)

    for flags, entry in ((["--var"], "predict_core"), (["--sample", "2"], "sample_core"),
                         (["--sample", "2", "--joint"], "sample_joint_core")):
        (ours,) = _serve_exe(exe, "--core", core_ab, "--requests", "3:2,5:0,3:2", *flags,
                             outdir=tmp_path / "e2")
        (want,) = _cli(serving.main, ["--state", str(tmp_path / "ab.srv"), "--device", "cpu",
                                      "--requests", "3:2,5:0,3:2", *flags,
                                      "--outdir", str(tmp_path / "s2")])
        assert ours["entry"] == entry
        _same(np.load(ours["npz"])["images"], np.load(want["npz"])["images"], name)

    core_a, core_a_b = str(tmp_path / "a.core.npz"), str(tmp_path / "a_b.core.npz")
    assert len(_serve_exe(exe, "--observe", obs["a"], "--save_core", core_a,
                          outdir=tmp_path)) == 1
    _serve_exe(exe, "--core", core_a, "--observe", obs["b"], "--save_core", core_a_b,
               outdir=tmp_path)
    with np.load(core_a_b) as two, np.load(core_ab) as one:
        np.testing.assert_allclose(two["G"], one["G"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(two["M"], one["M"], rtol=1e-4, atol=1e-5)


def test_exe_stdin_loop_equals_the_state_loop(runs, exes, tmp_path):
    """The one stdin loop over both surfaces: the same lines (a request past
    --max_batch with a ragged last chunk, an observe of 5 rows in chunks of
    2, errors, a save) get the same replies, images and variances under
    --exe as under --state; `save` writes the core npz, equal to the saved
    state's core."""
    run, exe = runs["bf16_polish"], exes["bf16_polish"]
    ds = _dataset()
    obs = str(tmp_path / "obs.npz")
    rows = ds.heldout_idx[:5]
    np.savez_compressed(obs, images=ds.images[rows], objects=ds.object_ids[rows],
                        views=ds.view_ids[rows])
    replies = {}
    for surface in ("state", "exe"):
        saved = str(tmp_path / ("saved.srv" if surface == "state" else "saved.core.npz"))
        lines = ["0:0,1:1,2:2,3:3,4:4", "", "3", "99:0", f"observe {obs}", "0:0,1:1,2:2",
                 f"save {saved}", "observe /nonexistent.npz", "1:1"]
        old = sys.stdin
        sys.stdin = io.StringIO("\n".join(lines) + "\n")
        try:
            serve = _serve if surface == "state" else _serve_exe
            replies[surface] = serve(run if surface == "state" else exe, "--stdin",
                                     "--max_batch", "2", outdir=tmp_path / surface)
        finally:
            sys.stdin = old
    ours, theirs = replies["exe"], replies["state"]
    assert set(ours[0]) == KEYS["ready"] | {"exe"} and ours[0]["max_batch"] == 2
    assert {k: v for k, v in ours[0].items() if k != "exe"} == theirs[0]
    assert [r["line"] for r in ours[1:]] == [r["line"] for r in theirs[1:]] == [0, 2, 3, 4, 5, 6,
                                                                                7, 8]
    for a, b in zip(ours[1:], theirs[1:]):
        assert set(a) == set(b)
        if "npz" in a:
            assert a["n_requests"] == b["n_requests"]
            _same_var(a["posterior_var"], b["posterior_var"])
            _same(np.load(a["npz"])["images"], np.load(b["npz"])["images"], "bf16_polish")
        elif "error" in a:
            assert a["error"] == b["error"]
        elif "observed" in a:
            assert a["observed"] == b["observed"] == 5
    back, _ = serving.load_server_state(str(tmp_path / "saved.srv"))
    with np.load(tmp_path / "saved.core.npz") as f:
        for k in f.files:
            np.testing.assert_allclose(f[k], getattr(back.core, k).numpy(), rtol=1e-5, atol=1e-6)
    # the saved core is served from with --core, also by the loop
    sys.stdin, old = io.StringIO("0:0\n"), sys.stdin
    try:
        again = _serve_exe(exe, "--stdin", "--core", str(tmp_path / "saved.core.npz"),
                           outdir=tmp_path / "again")
    finally:
        sys.stdin = old
    _same_var(again[1]["posterior_var"][:1], ours[5]["posterior_var"][:1])


@pytest.mark.parametrize("flags,match", [
    (["--stdin", "--requests", "3:2"], "persistent loop"),
    (["--stdin", "--sample", "2"], "persistent loop"),
    (["--stdin", "--repeat", "2"], "persistent loop"),
    (["--stdin", "--sustained", "2"], "persistent loop"),
    (["--stdin", "--var"], "persistent loop"),
    (["--stdin", "--observe", "x.npz"], "persistent loop"),
    (["--stdin", "--max_batch", "0"], "max_batch"),
    (["--observe", "x.npz"], "needs --save_core"),
    ([], "--exe needs --requests"),
    (["--requests", "3:2", "--joint"], "--joint modifies --sample"),
    (["--requests", "3:2", "--sample", "2", "--var"], "pass one of them"),
    (["--requests", "3:2", "--repeat", "2", "--sample", "2"], "baked posterior-mean program"),
    (["--requests", "3:2", "--sustained", "2", "--var"], "baked posterior-mean program"),
    (["--requests", "3:2", "--repeat", "2", "--core", "c.npz"], "baked posterior-mean program"),
    (["--requests", "3:2", "--sustained", "2", "--observe", "x.npz", "--save_core", "c"],
     "baked posterior-mean program"),
    (["--requests", "99:0"], "outside"),
    (["--requests", "3:2:5"], "want object:view"),
    (["--requests", "3:2", "--core", "BAD_KEYS"], "--core .*bad_keys.npz' holds"),
    (["--requests", "3:2", "--core", "BAD_SHAPE"], "--core .*bad_shape.npz' holds"),
    (["--stdin", "--core", "BAD_SHAPE"], "--core .*bad_shape.npz' holds"),
    (["--requests", "3:2", "--core", "MISSING"], "not a readable npz"),
])
def test_serve_exe_cli_refuses_flag_combinations(exes, flags, match, tmp_path):
    """The flag checks of the JAX CLI's --exe branch, with its messages, and
    a --core file that is not this artifact's posterior core: other keys,
    another R, or no file at all."""
    with np.load(exes["f32"]["exe"] + ".core.npz") as f:
        core = {k: f[k] for k in f.files}
    np.savez(tmp_path / "bad_keys.npz", M=core["M"], G=core["G"])
    np.savez(tmp_path / "bad_shape.npz", **{**core, "M": core["M"][:-1]})
    stand_ins = {"BAD_KEYS": str(tmp_path / "bad_keys.npz"), "MISSING": str(tmp_path / "no.npz"),
                 "BAD_SHAPE": str(tmp_path / "bad_shape.npz")}
    with pytest.raises(SystemExit, match=match):
        _serve_exe(exes["f32"], *(stand_ins.get(f, f) for f in flags), outdir=tmp_path)


@pytest.mark.parametrize("flags", [["--stdin"], ["--sample", "2"], ["--repeat", "2"], ["--var"],
                                   ["--sustained", "2"], ["--observe", "x.npz"]])
def test_export_exe_only_serializes(runs, flags, tmp_path):
    with pytest.raises(SystemExit, match="--export_exe only serializes"):
        _serve(runs["f32"], "--export_exe", str(tmp_path / "x.exe"), *flags, outdir=tmp_path)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("fault,error,match", [
    ("no_sidecar", FileNotFoundError, "compiled-program sidecar .* not found"),
    ("jax_format", ValueError, "records format 'jax.export.v2'; this build reads torch.export.v1"),
    ("no_format", ValueError, "records format None"),
    ("unknown_entry", ValueError, "no entry 'median'"),
    ("other_device", ValueError, "exported for \\['cpu'\\], not for 'cuda'"),
])
def test_load_compiled_program_errors_name_the_fault(exes, tmp_path, fault, error, match):
    """A missing sidecar, another format (the JAX package's included), an
    unknown entry and a device the artifact was not exported for each fail
    by name, before any program is read."""
    import shutil

    src = exes["f32"]["exe"]
    exe = str(tmp_path / "m.exe")
    for suffix in ("", ".meta.json", ".core.npz"):
        shutil.copy(src + suffix, exe + suffix)
    meta = json.loads(open(exe + ".meta.json").read())
    entry, device = "mean", None
    if fault == "no_sidecar":
        os.remove(exe + ".meta.json")
    elif fault == "jax_format":
        meta["format"] = "jax.export.v2"
    elif fault == "no_format":
        del meta["format"]
    elif fault == "unknown_entry":
        entry = "median"
    elif fault == "other_device":
        device = "cuda"
    if fault != "no_sidecar":
        with open(exe + ".meta.json", "w") as f:
            json.dump(meta, f)
    with pytest.raises(error, match=match):
        serving.load_compiled_program(exe, entry, device)
    if fault in ("no_sidecar", "jax_format"):  # the CLI fails the same way
        with pytest.raises(error, match=match):
            serving.main(["--exe", exe, "--device", "cpu", "--requests", "1:1"])


def test_entry_points_default_to_cuda(runs):
    """Without CUDA, generate and serve raise unless --device cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        generate.main(["--state", runs["f32"]["final"]])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serving.main(["--state", runs["f32"]["srv"], "--requests", "1:1"])


def test_export_server_rejects_grid_mismatch(runs, tmp_path):
    with pytest.raises(ValueError, match="does not match the checkpoint"):
        generate.main(["--state", runs["f32"]["final"], "--device", "cpu", "--num_objects",
                       "16", "--export_server", str(tmp_path / "srv")])


def test_generate_cli_other_modes(runs, tmp_path):
    run = runs["bf16_polish"]
    base = ["--state", run["final"], "--device", "cpu", "--outdir", str(tmp_path)]
    (rec,) = _cli(generate.main, [*base, "--object", "2"])
    assert set(rec) == {"views_panel", "object"} and os.path.isfile(rec["views_panel"])
    (rec,) = _cli(generate.main, [*base, "--sample", "4"])
    assert set(rec) == {"samples_panel", "n"} and os.path.isfile(rec["samples_panel"])
    (rec,) = _cli(generate.main, [*base, "--posterior_sample", "3", "--object", "1",
                                  "--view", "2"])
    assert set(rec) == {"posterior_panel", "object", "view", "n", "posterior_var"}
    assert rec["posterior_var"] > 0
    (rec,) = _cli(generate.main, [*base, "--posterior_sample", "3", "--object", "1", "--joint"])
    assert set(rec) == {"posterior_sweep_panel", "object", "n", "posterior_var"}
    assert len(rec["posterior_var"]) == 8 and os.path.isfile(rec["posterior_sweep_panel"])
    with pytest.raises(SystemExit, match="--joint modifies"):
        generate.main([*base, "--joint"])
    with pytest.raises(SystemExit, match="needs --object"):
        generate.main([*base, "--posterior_sample", "2"])


# -- parsers, panels, the checkpoint format, the package CLI ----------------------

@pytest.mark.parametrize("s", ["3:2,5:0", "0:0", " 1 : 2 ,3:4", "3", "3:2:5", "a:b", "99:0",
                               "0:8", "-1:0", "1:1,x", "", "1:1,,2:2"])
def test_parse_requests_matches_jax(s):
    for err in (ValueError, SystemExit):
        try:
            want = ("ok", jax_parse(s, 10, 8, err=err))
        except err as e:
            want = ("error", str(e))
        try:
            got = ("ok", serving._parse_requests(s, 10, 8, err=err))
        except err as e:
            got = ("error", str(e))
        assert got == want


@pytest.mark.parametrize("case", ["ok", "ids_alias", "no_images", "no_views", "shape",
                                  "ragged", "object_out", "view_out"])
def test_load_observation_npz_matches_jax(tmp_path, case):
    rng = np.random.default_rng(0)
    arrays = {"images": rng.uniform(size=(3, 32, 32, 1)).astype(np.float32),
              "objects": np.array([0, 4, 9]), "views": np.array([1, 0, 7])}
    if case == "ids_alias":
        arrays["object_ids"], arrays["view_ids"] = arrays.pop("objects"), arrays.pop("views")
    elif case == "no_images":
        arrays["pictures"] = arrays.pop("images")
    elif case == "no_views":
        del arrays["views"]
    elif case == "shape":
        arrays["images"] = arrays["images"][:, :16]
    elif case == "ragged":
        arrays["views"] = arrays["views"][:2]
    elif case == "object_out":
        arrays["objects"] = np.array([0, 10, 2])
    elif case == "view_out":
        arrays["views"] = np.array([0, -1, 2])
    path = str(tmp_path / "obs.npz")
    np.savez_compressed(path, **arrays)
    for err in (ValueError, SystemExit):
        try:
            want = ("ok", jax_load_obs(path, 10, 8, (32, 32, 1), err=err))
        except err as e:
            want = ("error", str(e))
        try:
            got = ("ok", serving._load_observation_npz(path, 10, 8, (32, 32, 1), err=err))
        except err as e:
            got = ("error", str(e))
        assert got[0] == want[0]
        if got[0] == "ok":
            for a, b in zip(got[1], want[1]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        else:
            assert got[1] == want[1]


@pytest.mark.parametrize("channels", [1, 3])
def test_save_panel_png_matches_jax(tmp_path, channels):
    """The port's zlib PNG decodes (PIL) to the pixels of the JAX package's
    PIL-written panel: rows of unequal length, values outside [0, 1]."""
    from PIL import Image

    rng = np.random.default_rng(channels)
    rows = [rng.uniform(-0.3, 1.3, (5, 12, 10, channels)).astype(np.float32),
            rng.uniform(0, 1, (4, 12, 10, channels))]
    ours, theirs = tmp_path / "ours" / "p.png", tmp_path / "theirs.png"
    save_panel(str(ours), rows)
    jax_save_panel(str(theirs), rows)
    a, b = Image.open(ours), Image.open(theirs)
    assert a.mode == b.mode == ("L" if channels == 1 else "RGB")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_tree_round_trip(tmp_path):
    tree = {"a": torch.arange(4.0), "b": {"c": torch.eye(2), "d": None}, "e": (1, "x")}
    path = str(tmp_path / "t")
    save_tree(path, tree)
    back = load_tree(path)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["b"]["d"] is None and tuple(back["e"]) == (1, "x")
    assert json.loads(open(path + ".format.json").read()) == {"format_version": FORMAT_VERSION}


@pytest.mark.parametrize("fault,match", [
    ("version", f"format_version=99, but this build reads v{FORMAT_VERSION}"),
    ("unreadable", "unreadable format sidecar"),
    ("missing", "no format sidecar"),
    ("garbage", f"as a format v{FORMAT_VERSION} tree"),
])
def test_checkpoint_format_errors_name_the_versions(tmp_path, fault, match):
    path = str(tmp_path / "t")
    save_tree(path, {"a": torch.ones(2)})
    if fault == "version":
        open(path + ".format.json", "w").write('{"format_version": 99}')
    elif fault == "unreadable":
        open(path + ".format.json", "w").write('{"format_ver')
    elif fault == "missing":
        os.remove(path + ".format.json")
    else:
        open(path, "wb").write(b"not a checkpoint")
    with pytest.raises(CheckpointFormatError, match=match):
        load_tree(path)


def test_load_without_meta_sidecar_fails_loudly(runs, tmp_path):
    state, meta = serving.load_server_state(runs["f32"]["srv"])
    path = str(tmp_path / "srv")
    serving.save_server_state(path, state, meta={"zdim": 6})
    os.remove(path + ".meta.json")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        serving.load_server_state(path)
    back, meta = serving.load_server_state(path, allow_missing_meta=True)
    assert meta == {} and torch.equal(back.core.M, state.core.M)


@pytest.mark.parametrize("argv,code,says", [
    (["train-cvae"], None, "driver=train_cvae epoch=0"), (["plot", "out"], None, "history.png"),
    (["bogus"], 2, "unknown command"), (["--help"], 0, "build-data"), ([], 1, "serve"),
])
def test_package_cli_commands(monkeypatch, capsys, tmp_path, argv, code, says):
    """Every command of `python -m gppvae_tpu_torch`: train-cvae and plot
    run (code None: no SystemExit), an unknown one exits 2."""
    if argv[:1] == ["train-cvae"]:
        argv = ["train-cvae", *GOLDEN_CLI[:-4], "--epochs", "1", "--outdir", str(tmp_path)]
    elif argv[:1] == ["plot"]:
        (tmp_path / "metrics.jsonl").write_text(
            json.dumps({"epoch": 0, "loss": 1.0, "oos_mse": 0.1, "sec_epoch": 0.1}) + "\n")
        argv = ["plot", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["gppvae_tpu_torch", *argv])
    if code is None:
        runpy.run_module("gppvae_tpu_torch", run_name="__main__")
    else:
        with pytest.raises(SystemExit) as e:
            runpy.run_module("gppvae_tpu_torch", run_name="__main__")
        assert e.value.code == code
    assert says in capsys.readouterr().out
    if code is None:
        written = {"train-cvae": "cvae_weights.pt", "plot": "history.png"}[argv[0]]
        assert (tmp_path / written).is_file()


def test_build_data_matches_jax(tmp_path, monkeypatch):
    flags = ["--data", "synthetic", "--num_objects", "6", "--num_views", "4", "--seed", "2"]
    monkeypatch.setattr(sys, "argv", ["gppvae_tpu_torch", "build-data", *flags,
                                      "--out", str(tmp_path / "ours.npz")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_module("gppvae_tpu_torch", run_name="__main__")
    with contextlib.redirect_stdout(io.StringIO()) as jbuf:
        jax_build_data([*flags, "--out", str(tmp_path / "theirs.npz")])
    ours, theirs = json.loads(buf.getvalue()), json.loads(jbuf.getvalue())
    assert {k: v for k, v in ours.items() if k != "out"} == \
        {k: v for k, v in theirs.items() if k != "out"}
    a, b = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "theirs.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    from gppvae_tpu_torch.data.build_cli import main as build_data

    with pytest.raises(SystemExit, match="already built"):
        build_data(["--data", "npz:x", "--out", "y"])
