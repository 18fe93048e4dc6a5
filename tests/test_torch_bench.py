"""bench_torch.py, the port's bench, held to bench.py; and its two tools.

Under the stubs of tests/test_bench_contract.py (train_vae raising,
train_gppvae returning a fake history, the accuracy protocol stubbed) both
benches run here and their artifacts agree: the error entries, the headline
median, the config names and each carried config's keys, less what the port
does not carry (named in NOT_CARRIED) and with the one rename of the float32
roofline (RENAMED). A cut run at the golden size on the CPU goes through
every config for real. Without a card and without `--device cpu` the bench
exits non-zero. torch_bench_diff's verdicts on hand-made artifacts, beside
tools/bench_diff.py's where both apply; torch_observe_throughput's chain
against direct observe calls.
"""

import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gppvae_tpu.utils.flops import gppvae_epoch_flops as jax_epoch_flops

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import bench  # noqa: E402
import bench_diff  # noqa: E402
import bench_torch  # noqa: E402
import torch_bench_diff  # noqa: E402
import torch_observe_throughput  # noqa: E402
import validate  # noqa: E402
import validate_torch  # noqa: E402

# what bench.py's artifact has and the port's does not (bench_torch.py's
# docstring gives each reason), and what the port adds
NOT_CARRIED = {"configs": {"gppvae_joint_f32_subpixel"},
               "keys": {"serving_program_sha1", "dispatch_declines_at_r56"},
               "extra": {"program_sha1"}}
ADDED = {"kernel_launches"}
RENAMED = {"mfu_vs_bf16_peak": "mfu_vs_fp32_peak"}  # in mfu.f32_resize: TF32 is off

# the golden size: widths and grids small enough for the CPU
GOLDEN = dict(zdim=6, batch_size=16, enc_features=(8, 16), dec_features=(16, 8), epochs=2)
GOLDEN_GP = dict(GOLDEN, obj_feature_dim=4, view_num_freqs=2)
GOLDEN_DIGITS = dict(bench_torch.DIGITS, num_objects=10, num_views=8)
GOLDEN_FACES = dict(bench_torch.FACES_128, num_objects=10, num_views=8, image_size=32)


class _FakeRes:
    """tests/test_bench_contract.py's fake training result: a history and
    nothing else, so that whatever reads the model fails inside its config."""

    def __init__(self, n_epochs, sec=0.015):
        self.history = [
            {"sec_epoch": sec + 0.001 * (i % 3), "oos_mse": 0.001, "mse": 0.002, "loss": 1.0}
            for i in range(n_epochs)
        ]


def _raise(*a, **k):
    raise RuntimeError("card lost")


@pytest.fixture
def one_thread():
    """One intra-op thread for a run of many small ops at the golden size:
    more gain nothing there, and with the test workers' processes sharing
    the cores each process's thread pool oversubscribes them (a golden cut
    run measured 14× slower beside seven busy processes, 8.5 s with one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("secs, skip", [
    ((9.0, 9.0, 0.03, 0.01, 0.02), 2),  # test_bench_sec_stats_distribution's
    ((0.51, 0.41, 0.43, 0.47, 0.40, 0.44), 1),
    ((0.3, 0.2, 0.1, 0.4), 2),
    ((1.25,), 0),
])
def test_sec_stats_and_median_are_bench_py_s(secs, skip):
    hist = [{"sec_epoch": s} for s in secs]
    assert bench_torch._sec_stats(hist, skip) == bench._sec_stats(hist, skip)
    assert bench_torch._median_sec(hist, skip) == bench._median_sec(hist, skip)


@pytest.fixture(scope="module")
def stubbed():
    """Both benches under the same stubs (one intra-op thread, as one_thread
    sets): (bench.py's artifact, the port's
    returned artifact, the port's printed lines, the stubbed protocol's
    keyword arguments). bench.py's digits grid is built without its cache
    directory, so that nothing here writes outside the test's own files."""
    import importlib

    import gppvae_tpu.data as jdata
    import gppvae_tpu.train as jtr
    from gppvae_tpu_torch.train import train_gppvae as ttg
    from gppvae_tpu_torch.train import train_vae as ttv

    protocol_kwargs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    build_digits = jdata.build_rotated_digits
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        stack.callback(torch.set_num_threads, threads)
        mp.setattr(jdata, "build_rotated_digits",
                   lambda *a, **k: build_digits(*a, **{**k, "cache_dir": None}))
        mp.setattr(bench, "_await_backend", lambda **kw: (True, "cpu"))
        mp.setattr(jtr, "train_vae", _raise)
        mp.setattr(jtr, "train_gppvae", lambda ds, cfg, **k: _FakeRes(cfg.epochs))
        importlib.import_module("gppvae_tpu.train.train_gppvae")
        mp.setattr(sys.modules["gppvae_tpu.train.train_gppvae"], "fused_epoch_program_hash",
                   lambda *a, **k: "deadbeefdeadbeef")
        mp.setattr(validate, "run_validation", lambda **kw: {"verdict": "STUBBED"})
        mp.setattr(ttv, "train_vae", _raise)
        mp.setattr(ttg, "train_gppvae", lambda ds, cfg, **k: _FakeRes(cfg.epochs))
        mp.setattr(validate_torch, "run_validation",
                   lambda **kw: protocol_kwargs.update(kw) or {"verdict": "STUBBED"})
        jbuf, tbuf = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(jbuf):
            bench.main()
        with contextlib.redirect_stdout(tbuf):
            port = bench_torch.main(["--device", "cpu"])
    return (json.loads(jbuf.getvalue().strip().splitlines()[-1]), port,
            tbuf.getvalue().strip().splitlines(), protocol_kwargs)


def test_bench_emits_artifact_despite_subconfig_failures(stubbed):
    """bench.py's contract test, on the port: a failed config is an error
    entry, the downstream configs degrade, the headline is the median of the
    epochs after the skip, and the last line is the artifact, under 2,000
    characters (the error messages shortened there, whole on their lines)."""
    jax_art, port, lines, protocol_kwargs = stubbed
    rec = json.loads(lines[-1])
    assert len(lines[-1]) < bench_torch.LAST_LINE_LIMIT
    assert set(rec["extra"]["configs"]) == set(port["extra"]["configs"])
    assert rec["metric"] == jax_art["metric"] == "rotated_mnist_gppvae_joint_sec_per_epoch"
    assert rec["value"] == pytest.approx(0.016, abs=1e-9)
    assert rec["value"] == port["value"] == jax_art["value"]
    cfgs = rec["extra"]["configs"]
    for name in ("vae_pretrain", "oos_generation", "oos_serving", "face_view_128"):
        assert "error" in cfgs[name] and "error" in jax_art["extra"]["configs"][name], name
    assert cfgs["gppvae_joint"]["sec_epoch_min"] == 0.015
    assert np.isfinite(cfgs["gppvae_joint"]["oos_mse"])
    assert cfgs["kernels"] == {"skipped": "device 'cpu' is not cuda"}
    assert protocol_kwargs["device"] == "cpu" and protocol_kwargs["fast"] is True
    # one line per config, in the table's order, before the artifact
    assert [json.loads(x)["config"] for x in lines[:-1]] == list(bench_torch.TABLE)


def test_artifact_keys_are_bench_py_s(stubbed):
    """The config names, and each carried config's keys, are bench.py's
    under the same stubs, less NOT_CARRIED, plus ADDED; the roofline's keys
    with RENAMED; the analytic FLOP counts equal."""
    jax_art, port, _, _ = stubbed
    assert set(port) == set(jax_art)
    assert set(port["extra"]) == set(jax_art["extra"]) - NOT_CARRIED["extra"]
    jc, tc = jax_art["extra"]["configs"], port["extra"]["configs"]
    assert set(tc) == set(jc)
    for name in set(jc) - NOT_CARRIED["configs"]:
        assert set(tc[name]) - ADDED == set(jc[name]) - NOT_CARRIED["keys"], name
    for name in NOT_CARRIED["configs"]:
        assert set(tc[name]) == {"skipped"}
    jm, tm = jax_art["extra"]["mfu"], port["extra"]["mfu"]
    assert set(tm) == set(jm)
    assert set(tm["f32_resize"]) == {RENAMED.get(k, k) for k in jm["f32_resize"]}
    assert tm["flops_per_epoch"] == jm["flops_per_epoch"]
    assert tm["f32_resize"]["flops_per_epoch"] == jm["f32_resize"]["flops_per_epoch"]


def test_without_a_card_the_bench_exits_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "not falling back" in out.stderr
    assert not [x for x in out.stdout.splitlines() if x.startswith("{")]


def test_cut_run_on_the_cpu_at_the_golden_size(capsys, one_thread):
    """Every config for real at the golden size (no accuracy block: its
    protocol has its own tests): no error, a skipped kernels block, the
    plain versions once per GPPVAE epoch and never elsewhere, and the
    roofline's FLOP the JAX package's count for the same arguments."""
    vae = {k: v for k, v in GOLDEN.items()}
    table = bench_torch.cut(
        bench_torch.TABLE, accuracy=None,
        vae_pretrain=dict(data=GOLDEN_DIGITS, skip=1, train=vae),
        **{n: dict(data=GOLDEN_DIGITS, skip=1, train=GOLDEN_GP)
           for n in ("gppvae_dis", "gppvae_joint_f32", "gppvae_joint")},
        face_view_128=dict(data=GOLDEN_FACES, skip=1, train=GOLDEN_GP, serve_batch=40, chain=4),
        face_accuracy_64=dict(data=GOLDEN_FACES, skip=1, train=GOLDEN_GP),
        oos_serving=dict(chain=5))
    art = bench_torch.main(["--device", "cpu"], table=table)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["value"] == art["value"] and len(last) < bench_torch.LAST_LINE_LIMIT
    cfgs = art["extra"]["configs"]
    assert set(cfgs) == set(table) and not [n for n, c in cfgs.items() if "error" in c]
    assert cfgs["kernels"] == {"skipped": "device 'cpu' is not cuda"}
    gppvae = ("gppvae_dis", "gppvae_joint_f32", "gppvae_joint", "face_view_128",
              "face_accuracy_64")
    for name in gppvae:
        assert cfgs[name]["kernel_launches"] == {"factor_prep": 2, "woodbury_nll_core": 2}, name
    for name in ("vae_pretrain", "oos_generation", "oos_serving"):
        assert cfgs[name]["kernel_launches"] == {"factor_prep": 0, "woodbury_nll_core": 0}, name
    assert cfgs["face_view_128"]["serving_batch"] == 40  # the 10 held-out cells, tiled
    assert cfgs["oos_serving"]["model_dtype"] == "bfloat16"
    assert math.isfinite(cfgs["oos_generation"]["heldout_mse"])
    ds = bench_torch.build_dataset(**GOLDEN_DIGITS)
    kw = dict(image_shape=ds.image_shape, enc_features=(8, 16), dec_features=(16, 8), zdim=6,
              n_train=len(ds.train_idx), n_heldout=len(ds.heldout_idx), batch_size=16,
              rank=4 * (2 * 2 + 1))
    mfu = art["extra"]["mfu"]
    assert art["extra"]["n_train"] == len(ds.train_idx)
    assert mfu["flops_per_epoch"] == jax_epoch_flops(**kw, upsample="subpixel")["total"]
    assert mfu["f32_resize"]["flops_per_epoch"] == jax_epoch_flops(**kw)["total"]


def _artifact(value=0.5, sec_min=0.5, sustained=10000, verdict="PASS", win_ok=True,
              power="700.00 W", sha="abc"):
    return {"metric": "rotated_mnist_gppvae_joint_sec_per_epoch", "value": value,
            "extra": {"device": {"name": "NVIDIA H100 80GB HBM3",
                                 "nvidia_smi": f"NVIDIA H100 80GB HBM3, {power}"},
                      "program_sha1": sha,
                      "configs": {
                          "gppvae_joint_f32": {"sec_epoch": sec_min, "sec_epoch_min": sec_min},
                          "face_view_128": {"serving_sustained_b200_images_per_sec": sustained,
                                            "serving_batch": 200, "model_dtype": "float32",
                                            "serving_program_sha1": sha},
                          "face_accuracy_64": {"verdict": verdict},
                          "kernels": {"win_ok": win_ok}}}}


@pytest.mark.parametrize("case", ["same", "slower", "another_card", "verdict_flip"])
def test_bench_diff_verdicts(case, tmp_path):
    """torch_bench_diff on hand-made artifacts, and tools/bench_diff.py on
    the same ones where its rules apply (a program hash standing for the
    card): the headline and the verdicts give the same outcome."""
    old = _artifact()
    new = {"same": _artifact(value=0.52, sec_min=0.51, sustained=9900),
           "slower": _artifact(value=0.7, sec_min=0.7, sustained=7000),
           "another_card": _artifact(value=0.7, sec_min=0.7, sustained=7000, power="500.00 W",
                                     sha="def"),
           "verdict_flip": _artifact(verdict="FAIL", win_ok=False, power="500.00 W",
                                     sha="def")}[case]
    got, ref = torch_bench_diff.diff(old, new), bench_diff.diff(old, new)
    n_reg = {"same": 0, "slower": 3, "another_card": 0, "verdict_flip": 2}[case]
    assert len(got["regressions"]) == n_reg, got
    assert got["ok"] == ref["ok"] == (n_reg == 0)
    assert bool(got["non_comparable"]) == bool(ref["non_comparable"]) == (
        case in ("another_card", "verdict_flip"))
    headline = [x for x in got["regressions"] + got["non_comparable"] if x.startswith("headline")]
    ref_headline = [x for x in ref["regressions"] + ref["non_comparable"]
                    if x.startswith("headline")]
    assert bool(headline) == bool(ref_headline) == (case in ("slower", "another_card"))
    flips = [sorted(x for x in d["regressions"] if "verdict" in x or "win_ok" in x)
             for d in (got, ref)]
    assert flips[0] == flips[1] and len(flips[0]) == (2 if case == "verdict_flip" else 0)

    # the three forms of input, and the exit codes
    line = json.dumps(new)
    forms = {"raw.json": line,
             "wrapper.json": json.dumps({"cmd": "python3 bench_torch.py", "rc": 0,
                                         "parsed": new, "tail": ""}),
             "cut_wrapper.json": json.dumps({"cmd": "", "rc": 0, "parsed": None,
                                             "tail": '{"config": "x"}\n' + line + "\n"}),
             "log.txt": "# bench_torch: device\n" + '{"config": "x", "a": 1}\n' + line + "\n"}
    (tmp_path / "old.json").write_text(json.dumps(old))
    for name, text in forms.items():
        (tmp_path / name).write_text(text)
        assert torch_bench_diff.load_artifact(str(tmp_path / name)) == new
        rc = torch_bench_diff.main([str(tmp_path / "old.json"), str(tmp_path / name)])
        assert rc == (1 if n_reg else 0)
    (tmp_path / "none.txt").write_text('{"config": "x"}\n')
    assert torch_bench_diff.main([str(tmp_path / "old.json"), str(tmp_path / "none.txt")]) == 2


def test_last_line_compacts_a_full_artifact_under_the_limit():
    """A whole artifact at the card's magnitudes (every config, five kernels
    rows, the accuracy block) is over 2,000 characters; the last line keeps
    the headline, each config's sec_epoch_min, rates and verdicts under it."""
    row = {"shape": [262144, 512, 16], "max_abs_err": 1.2345678e-05, "rel_err": 3.4567e-07,
           "rel_bound": 1e-05, "ms": 0.8234567891, "plain_ms": 0.91234567,
           "library_ms": 0.712345678, "device_ms": 0.7123456, "device_ms_method": "profiler",
           "bound_ms": 0.1234567, "bound_by": "operations", "speedup": 0.86512345}
    kl = {"factor_prep": 240, "woodbury_nll_core": 240}
    train = {"sec_epoch": 0.5123, "sec_epoch_min": 0.5012, "sec_epoch_spread": 0.0234,
             "oos_mse": 0.01234, "kernel_launches": kl}
    configs = {
        "vae_pretrain": {**train, "mse": 0.01234},
        "gppvae_dis": train,
        "gppvae_joint_f32": {**train, "images_per_sec": 11234, "config": "x" * 48},
        "gppvae_joint_f32_subpixel": {"skipped": "y" * 120},
        "gppvae_joint": {**train, "images_per_sec": 11234, "config": "x" * 48},
        "face_view_128": {**train, "serving_sustained_b200_images_per_sec": 10834,
                          "serving_batch": 200, "model_dtype": "float32",
                          "dec_upsample": "subpixel"},
        "face_accuracy_64": {**train, "epochs": 240, "oos_mse_final": 0.00456,
                             "oos_mse_best": 0.00432, "threshold": 0.01, "verdict": "PASS",
                             "config": "x" * 48},
        "oos_generation": {"images_per_sec": 41234, "n_heldout": 400, "heldout_mse": 0.01234,
                           "config": "x" * 55, "kernel_launches": kl},
        "oos_serving": {"latency_s_per_batch": 0.003123, "batch": 400,
                        "sustained_images_per_sec": 181234, "config": "x" * 48,
                        "model_dtype": "bfloat16", "dec_upsample": "subpixel",
                        "kernel_launches": kl},
        "kernels": {"factor_prep": [row] * 3, "nll_core": [row] * 2, "win_ok": False},
        "accuracy": {"verdict": "PASS", **{f"{m}_oos_mse": 0.0043456789 for m in (
            "gppvae_joint", "gppvae_dis", "livae", "cvae")}, "protocol": {"p": "z" * 120},
            **{k: 0.0625583678483963 for k in ("baseline_train_mean", "baseline_per_view_mean",
                                               "joint_vs_best_baseline", "joint_vs_dis",
                                               "joint_vs_cvae")}, "wall_s": 180.3},
    }
    art = {"metric": bench_torch.METRIC, "value": 0.5123, "unit": "s/epoch", "vs_baseline": None,
           "extra": {"device": {"name": "NVIDIA H100 80GB HBM3",
                                "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
                     "n_train": 5700, "joint_total_wall_s": 20.3, "configs": configs,
                     "mfu": {"flops_per_epoch": 312345678901, "flops_phase_c_frac": 0.962,
                             "achieved_tflops": 0.6123, "mfu_vs_bf16_peak": 0.000619,
                             "f32_resize": {"flops_per_epoch": 412345678901,
                                            "achieved_tflops": 0.8123,
                                            "mfu_vs_fp32_peak": 0.012123}}}}
    before = copy.deepcopy(art)
    line = bench_torch.last_line(art)
    assert len(json.dumps(art)) > bench_torch.LAST_LINE_LIMIT > len(line)
    assert art == before  # the caller's artifact is left whole
    rec = json.loads(line)
    assert rec["value"] == 0.5123 and rec["extra"]["compacted"] >= 1
    c = rec["extra"]["configs"]
    assert c["accuracy"]["verdict"] == "PASS" and c["kernels"]["win_ok"] is False
    assert c["face_accuracy_64"]["verdict"] == "PASS"
    assert c["face_view_128"]["serving_sustained_b200_images_per_sec"] == 10834
    assert all(c[n]["sec_epoch_min"] == 0.5012 for n in ("gppvae_dis", "gppvae_joint"))
    # torch_bench_diff reads the compacted line as it reads the whole artifact
    assert torch_bench_diff.diff(before, rec)["ok"]


def test_observe_chain_equals_direct_observe_calls(one_thread):
    """measure()'s timed chain folds what the same number of direct
    eval.serving.observe calls folds, on a tiny grid on the CPU."""
    from gppvae_tpu_torch.eval.serving import observe

    ds_kwargs = dict(grid="rotated_digits", num_objects=12, num_views=8, image_size=32, seed=0)
    model_kwargs = dict(zdim=4, enc_features=(8, 16), dec_features=(16, 8), obj_feature_dim=2,
                        view_num_freqs=1)
    row, final = torch_observe_throughput.measure("tiny", ds_kwargs, model_kwargs, bs=10,
                                                  chain=3, reps=1, device="cpu")
    p = torch_observe_throughput.prepare(ds_kwargs, model_kwargs, bs=10, device="cpu")
    state = p.state
    for _ in range(3):
        state = observe(p.model, state, p.images, p.d, p.q, x_map=p.x_map,
                        extra_effects=p.extra, encode_chunk=10,
                        row_mask=torch.ones(10))
    for name, got, want in zip(final.core._fields, final.core, state.core):
        assert torch.equal(got, want), name
    assert not torch.equal(state.core.M, p.state.core.M)  # the folds did fold
    assert {k: row[k] for k in ("config", "fold_batch", "chain", "rank", "zdim")} == {
        "config": "tiny", "fold_batch": 10, "chain": 3, "rank": 2 * 3, "zdim": 4}
    assert row["rows_per_sec"] > 0 and row["folds_per_sec"] > 0
