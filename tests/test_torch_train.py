"""The port's training drivers against the JAX trainer.

At the golden config (tests/test_golden.py): the port starts from the JAX
trainer's own initial params (gppvae_tpu.train.train_gppvae._setup, converted)
and is fed the JAX trainer's own draws (batching.epoch_keys → epoch_batches,
then ε from split(fold_in(epoch_key, 1), nb)). Tolerances (float32):
  * one Phase-C step: metrics rtol 1e-5; every updated param atol 2e-6 /
    rtol 1e-4 (Adam's first step moves each param by ~lr = 5e-4, so the
    atol is 0.4 % of one step);
  * the 2-epoch GPPVAE trajectory ('joint', 'dis', and joint with each
    trainer option: the rbf and rbf-nystrom object kernels with the JAX RFF
    draws and landmarks injected, extra effects, learn_sigma_y, gradient
    accumulation, sub-epoch refresh, the subpixel decoder): every history
    key rtol 1e-4.
The same trajectories with NO injection and NO converted weights (the
port's own init and draws at the JAX trainer's seed, the JAX package's
stream: utils/prng.py), 'joint' and 'dis', and train_vae's: every history
key rtol 1e-4.
The optimizer tests run in float64 and hold the port to optax at 1e-12.
"""

import ast
import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gppvae_tpu import gp as jgp
from gppvae_tpu.data import build_rotated_digits
from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches
from gppvae_tpu.train.batching import epoch_keys
from gppvae_tpu_torch import ops
from gppvae_tpu_torch.checkpoint import CheckpointFormatError
from gppvae_tpu_torch.convert import flax_to_state_dict, rff_draws_from_map
from gppvae_tpu_torch.eval import predict_heldout
from gppvae_tpu_torch.models import encode_all
from gppvae_tpu_torch.train import train_gppvae, train_vae
from gppvae_tpu_torch.train.optim import GuardedAdam, resolve_grad_accum
from gppvae_tpu_torch.utils import prng
from _one_thread import one_thread  # noqa: F401

# the module (gppvae_tpu.train re-exports a function of the same name)
jtrain = importlib.import_module("gppvae_tpu.train.train_gppvae")
REPO = Path(__file__).resolve().parent.parent
GOLDEN = dict(mode="joint", zdim=6, epochs=2, batch_size=16, lr_vae=5e-4,
              lr_gp=5e-3, seed=7, obj_feature_dim=4, view_num_freqs=2,
              enc_features=(8, 16), dec_features=(16, 8))
GOLDEN_CLI = ["--data", "synthetic", "--num_objects", "10", "--num_views", "8",
              "--zdim", "6", "--bs", "16", "--enc_features", "8,16",
              "--dec_features", "16,8", "--seed", "7", "--device", "cpu"]
# the trajectory cases: config overrides of GOLDEN (66 train rows, 5 steps
# per epoch, so k = 2 accumulation carries a step across the epoch boundary)
CASES = {
    "joint": dict(mode="joint"),
    "dis": dict(mode="dis"),
    "rbf": dict(object_kernel="rbf", rff_features=16, rff_lengthscale=0.8),
    "rbf-nystrom": dict(object_kernel="rbf-nystrom", rff_features=16, nystrom_rank=6),
    "extra_effects": dict(extra_effects=("object", "view")),
    "learn_sigma_y": dict(learn_sigma_y=True),
    "grad_accum_steps": dict(grad_accum_steps=2),
    "refresh_every_steps": dict(refresh_every_steps=2),
    "subpixel": dict(dec_upsample="subpixel"),
}


@functools.cache
def _golden(case):
    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=7)
    jcfg = jtrain.GPPVAETrainConfig(**{**GOLDEN, **CASES[case]})
    model, params, fixed_W, arrays, rng, num_train = jtrain._setup(ds, jcfg, None, None)
    init = {
        "vae": flax_to_state_dict(jax.tree.map(np.asarray, params["vae"])),
        "gp": {k: np.asarray(v) for k, v in params["gp"].items()},
    }
    if jcfg.object_kernel != "linear":
        jfn, _ = jgp.make_rff_map(jcfg.obj_feature_dim, jcfg.rff_features,
                                  jcfg.rff_lengthscale, seed=jcfg.seed)
        init["rff"] = rff_draws_from_map(jfn)
    if jcfg.object_kernel == "rbf-nystrom":
        init["nystrom_idx"] = np.asarray(jtrain._select_nystrom_landmarks(params["gp"]["X"], jcfg))
    return dict(ds=ds, jcfg=jcfg, model=model, params=params, fixed_W=fixed_W,
                arrays=arrays, rng=rng, num_train=num_train, init=init)


@pytest.fixture
def golden():
    return _golden("joint")


@functools.cache
def _jax_run(case):
    """The JAX trainer's 2-epoch run of a case, once per test process."""
    g = _golden(case)
    return jtrain.train_gppvae(g["ds"], g["jcfg"], log=_Quiet())


def _jax_plan(rng, epoch, num_train, bs, zdim, nb=None):
    """The JAX trainer's draws for one epoch (train_gppvae.py:456,507-508)."""
    key = epoch_keys(rng, epoch, 1)[0]
    batches, weights = jax_epoch_batches(key, num_train, bs)
    nb = nb or batches.shape[0]
    step_keys = jax.random.split(jax.random.fold_in(key, 1), nb)
    eps = jnp.stack([jax.random.normal(k, (bs, zdim), jnp.float32) for k in step_keys])
    return key, batches[:nb], weights[:nb], eps


def _to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port(golden, **overrides):
    cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, **overrides})
    model, gp_params, fixed_W, data, n = train_gppvae._setup(
        golden["ds"], cfg, torch.device("cpu"), golden["init"])
    return train_gppvae._Loop(model, gp_params, fixed_W, data, n, cfg)


def test_one_phase_c_step_matches_jax(golden, monkeypatch):
    g = golden
    cfg = g["jcfg"]
    accum = 1
    opt_vae = jtrain.make_optimizer(cfg.lr_vae, cfg.clip_grad_norm, accum)
    opt_gp = jtrain.make_optimizer(cfg.lr_gp, cfg.clip_grad_norm, accum)
    jloop = jtrain._Loop(g["model"], opt_vae, opt_gp, cfg, g["num_train"], None)
    a = g["arrays"]
    Z0, coeffs = jloop.refresh_and_solve(g["params"], g["fixed_W"], a["images_tr"],
                                         a["d_tr"], a["q_tr"])
    key, batches, weights, eps = _jax_plan(g["rng"], 0, g["num_train"], 16, 6, nb=1)
    # run the JAX trainer's own minibatch scan for its first step only
    monkeypatch.setattr(jtrain, "epoch_batches", lambda k, n, bs: (batches, weights))
    jloop.nb = 1
    params1, _, _, jm = jloop.minibatch_epoch(
        g["params"], opt_vae.init(g["params"]["vae"]), opt_gp.init(g["params"]["gp"]),
        g["fixed_W"], a["images_tr"], a["d_tr"], a["q_tr"], coeffs, key)

    loop = _port(g)
    tZ0 = loop.encode()
    np.testing.assert_allclose(tZ0.numpy(), np.asarray(Z0), rtol=1e-4, atol=1e-5)
    tcoeffs = loop.solve(tZ0)
    np.testing.assert_allclose(float(tcoeffs.value), float(coeffs.value), rtol=1e-5)
    pos, w, e = _to_torch(batches[0], weights[0], eps[0])
    m = loop.minibatch_step(tcoeffs, pos.long(), w, e)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5)

    want = flax_to_state_dict(jax.tree.map(np.asarray, params1["vae"]))
    for k, v in loop.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=k)
    for k, v in loop.gp.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(params1["gp"][k]),
                                   rtol=1e-4, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("mode", list(CASES))
def test_two_epoch_trajectory_matches_jax(mode):
    g = _golden(mode)
    jres = _jax_run(mode)
    nb = -(-g["num_train"] // 16)

    def draws(epoch):
        _, batches, weights, eps = _jax_plan(g["rng"], epoch, g["num_train"], 16, 6)
        assert batches.shape[0] == nb
        b, w, e = _to_torch(batches, weights, eps)
        return b.long(), w, e

    cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, **CASES[mode]})
    if cfg.object_kernel == "rbf-nystrom":  # the port picks the JAX landmarks itself
        own = train_gppvae._select_nystrom_landmarks(
            torch.tensor(g["init"]["gp"]["X"]), g["init"]["rff"], cfg)
        np.testing.assert_array_equal(own, g["init"]["nystrom_idx"])
        assert len(own) == cfg.nystrom_rank
    res = train_gppvae.train_gppvae(g["ds"], cfg, device="cpu", init_params=g["init"],
                                    draws=draws, log=_Quiet())
    assert len(res.history) == len(jres.history) == 2
    for ours, theirs in zip(res.history, jres.history):
        for k in train_gppvae._METRIC_KEYS:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)
        assert ours["sec_epoch"] > 0


class _Quiet:
    def log(self, rec):
        pass


@pytest.mark.parametrize("mode", ["joint", "dis"])
def test_two_epoch_trajectory_matches_jax_without_injection(mode):
    """The port trains from config.seed alone: flax's init of the VAE from
    the JAX trainer's init key, X₀, the plans and every step's ε from its
    keys. No draws injected and no weights converted: the JAX trainer's
    2-epoch history, every key rtol 1e-4."""
    g = _golden(mode)
    cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, **CASES[mode]})
    res = train_gppvae.train_gppvae(g["ds"], cfg, device="cpu", log=_Quiet())
    assert len(res.history) == len(_jax_run(mode).history) == 2
    for ours, theirs in zip(res.history, _jax_run(mode).history):
        for k in train_gppvae._METRIC_KEYS:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)


def test_setup_draws_the_jax_trainers_init():
    """_setup's fresh VAE, X₀ and W₀ from the seed equal jtrain._setup's
    (flax's model.init and the normal draws), to 1e-7."""
    g = _golden("joint")
    cfg = train_gppvae.GPPVAETrainConfig(**GOLDEN)
    model, gp_params, *_ = train_gppvae._setup(g["ds"], cfg, torch.device("cpu"))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), g["init"]["vae"][k].numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)
    for k, v in gp_params.items():
        np.testing.assert_allclose(v.detach().numpy(), g["init"]["gp"][k], rtol=0, atol=1e-7,
                                   err_msg=k)


def test_train_vae_matches_jax_without_injection():
    """train_vae from the seed alone (flax init, plans, ε and the
    validation rows' ε from the JAX trainer's keys) against the JAX
    trainer's 2-epoch history, every key rtol 1e-4."""
    jvae = importlib.import_module("gppvae_tpu.train.train_vae")
    ds = _golden("joint")["ds"]
    kw = dict(zdim=6, epochs=2, batch_size=16, lr=5e-4, seed=7, enc_features=(8, 16),
              dec_features=(16, 8))
    jres = jvae.train_vae(ds, jvae.VAETrainConfig(**kw), log=_Quiet())
    res = train_vae.train_vae(ds, train_vae.VAETrainConfig(**kw), device="cpu", log=_Quiet())
    assert len(res.history) == len(jres.history) == 2
    for ours, theirs in zip(res.history, jres.history):
        assert set(ours) == set(theirs)
        for k in set(ours) - {"driver", "epoch", "sec_epoch"}:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("mode", ["dis", "joint"])
def test_twelve_epoch_trajectory_matches_jax_at_dispatch_10(mode):
    """The accuracy protocol runs the JAX trainer's fused path at
    epochs_per_dispatch=10 (validate.py:134), every other parity trajectory
    here at 1 and for 2 epochs. 12 epochs (one dispatch of 10, one of 2)
    with the reference's draws injected: every history key at rtol 1e-4, so
    neither the dispatch size nor a drift that needs more than 2 epochs to
    show separates the port from the reference."""
    g = _golden(mode)
    jcfg = jtrain.GPPVAETrainConfig(**{**GOLDEN, **CASES[mode], "epochs": 12,
                                       "epochs_per_dispatch": 10})
    jres = jtrain.train_gppvae(g["ds"], jcfg, log=_Quiet())

    def draws(epoch):
        _, batches, weights, eps = _jax_plan(g["rng"], epoch, g["num_train"], 16, 6)
        b, w, e = _to_torch(batches, weights, eps)
        return b.long(), w, e

    cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, **CASES[mode], "epochs": 12})
    res = train_gppvae.train_gppvae(g["ds"], cfg, device="cpu", init_params=g["init"],
                                    draws=draws, log=_Quiet())
    assert [h["epoch"] for h in res.history] == [h["epoch"] for h in jres.history] \
        == list(range(12))
    for ours, theirs in zip(res.history, jres.history):
        for k in train_gppvae._METRIC_KEYS:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4,
                                       err_msg=f"epoch {ours['epoch']} {k}")


def test_random_view_features_come_from_a_fixed_key():
    """With no one-column view aux the view features are random unit rows:
    the JAX trainer's normal(PRNGKey(7)) rows (train_gppvae.py:229), the
    same at two training seeds, and X₀ does not move with them. The draws
    are bit-equal to jax.random's; W₀ equals the JAX trainer's within 2
    ulp, the row norm's last bit (XLA fuses the squares into its sum as
    fused multiply-adds) passed on by the division."""
    import dataclasses

    ds = _golden("joint")["ds"]
    auxless = dataclasses.replace(ds, view_aux=np.zeros((ds.num_views, 2), np.float32))
    jW = np.asarray(jtrain._init_view_features(jtrain.GPPVAETrainConfig(**GOLDEN), auxless))
    runs = {}
    for name, data, seed in (("aux", ds, 7), ("auxless", auxless, 7),
                             ("auxless_seed3", auxless, 3)):
        cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, "seed": seed, "epochs": 1})
        _, gp_params, *_ = train_gppvae._setup(data, cfg, torch.device("cpu"))
        runs[name] = (gp_params["W"].detach(), gp_params["X"].detach())
    W = runs["auxless"][0]
    assert W.shape == (8, 5) and torch.equal(W, runs["auxless_seed3"][0])
    np.testing.assert_array_equal(
        prng.normal(prng.PRNGKey(7), (8, 5)),
        np.asarray(jax.random.normal(jax.random.PRNGKey(7), (8, 5), jnp.float32)))
    np.testing.assert_array_max_ulp(W.numpy(), jW, maxulp=2)
    np.testing.assert_allclose(W.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    assert not torch.equal(W, runs["aux"][0])  # Fourier rows there
    assert torch.equal(runs["auxless"][1], runs["aux"][1])  # X₀ from its own key
    assert not torch.equal(runs["auxless"][1], runs["auxless_seed3"][1])
    res = train_gppvae.train_gppvae(auxless, train_gppvae.GPPVAETrainConfig(
        **{**GOLDEN, "epochs": 1}), device="cpu", log=_Quiet())
    assert np.isfinite(res.history[0]["oos_mse"])


def test_cli_entry_points_on_cpu(tmp_path):
    ops.reset_launch_counts()
    vae = train_vae.main([*GOLDEN_CLI, "--epochs", "1", "--outdir", str(tmp_path / "vae")])
    weights = tmp_path / "vae" / train_vae.WEIGHTS_FILE
    assert weights.is_file() and np.isfinite(vae.history[0]["loss"])
    res = train_gppvae.main([*GOLDEN_CLI, "--epochs", "1", "--mode", "joint",
                             "--xdim", "4", "--view_freqs", "2",
                             "--vae_weights", str(weights),
                             "--outdir", str(tmp_path / "gppvae")])
    rec = res.history[0]
    assert all(np.isfinite(rec[k]) for k in train_gppvae._METRIC_KEYS)
    assert (tmp_path / "gppvae" / train_gppvae.FINAL_PARAMS_FILE).is_file()
    assert (tmp_path / "gppvae" / "metrics.jsonl").is_file()
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain versions only


def test_device_and_unported_options_raise(golden, tmp_path):
    """--device cuda without CUDA raises; no trainer option is left
    unported: resume continues a run from its final_state (and a path that
    holds no state fails with the checkpoint format's error before any
    training); unknown option values raise ValueError as the JAX trainer
    does."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_gppvae.main(["--device", "cuda", "--epochs", "1"])
    assert not hasattr(train_gppvae, "_UNPORTED")
    first = _train(golden, outdir=str(tmp_path))
    more = _train(golden, epochs=3, resume=str(tmp_path / train_gppvae.FINAL_STATE_FILE))
    assert [h["epoch"] for h in first.history] == [0, 1]
    assert [h["epoch"] for h in more.history] == [2]
    assert more.optimizers["vae"].steps == first.optimizers["vae"].steps * 3 // 2
    with pytest.raises(CheckpointFormatError, match="no format sidecar"):
        _train(golden, resume=str(tmp_path / "x"))
    for bad, what in ((dict(extra_effects=("pose",)), "extra effect"),
                      (dict(object_kernel="matern"), "object_kernel"),
                      (dict(compute_dtype="float16"), "compute_dtype"),
                      (dict(grad_accum_steps=0), "grad_accum_steps")):
        cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, **bad})
        with pytest.raises(ValueError, match=what):
            train_gppvae.train_gppvae(golden["ds"], cfg, device="cpu", log=_Quiet())


def test_unknown_extra_effect_raises_before_any_work(golden, monkeypatch):
    """A bad --extra_effects name fails while the epoch loop is set up, not
    at the first Phase B after an encode."""
    def no_encode(self):
        raise AssertionError("encoded before the bad option was rejected")

    monkeypatch.setattr(train_gppvae._Loop, "encode", no_encode)
    cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, "extra_effects": ("object", "pose")})
    with pytest.raises(ValueError, match="unknown extra effect 'pose'"):
        train_gppvae.train_gppvae(golden["ds"], cfg, device="cpu", log=_Quiet())


def test_package_imports_no_jax(tmp_path):
    code = (
        "import importlib, pkgutil, sys, gppvae_tpu_torch\n"
        "for m in pkgutil.walk_packages(gppvae_tpu_torch.__path__, 'gppvae_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gppvae_tpu_torch.train import train_gppvae\n"
        f"train_gppvae.main({[*GOLDEN_CLI, '--epochs', '1', '--xdim', '4', '--view_freqs', '2']!r}"
        " + ['--outdir', sys.argv[1]])\n"
        f"train_gppvae.main({[*GOLDEN_CLI, '--epochs', '1', '--xdim', '4', '--view_freqs', '2', '--object_kernel', 'rbf-nystrom', '--extra_effects', 'object', '--dtype', 'bfloat16', '--dec_upsample', 'subpixel']!r}"
        " + ['--outdir', sys.argv[1] + '/options'])\n"
        "from gppvae_tpu_torch.eval import generate, serving\n"
        "for run in (sys.argv[1], sys.argv[1] + '/options'):\n"
        "    generate.main(['--state', run + '/final_params.pt', '--device', 'cpu',\n"
        "                   '--export_server', run + '/m.srv'])\n"
        "    serving.main(['--state', run + '/m.srv', '--device', 'cpu', '--requests',\n"
        "                  '1:2,3:0', '--sample', '2', '--joint', '--outdir', run + '/served'])\n"
        "serving.main(['--state', run + '/m.srv', '--device', 'cpu', '--export_exe',\n"
        "              run + '/m.exe'])\n"
        "serving.main(['--exe', run + '/m.exe', '--device', 'cpu', '--requests', '1:2,3:0',\n"
        "              '--sample', '2', '--joint', '--outdir', run + '/served_exe'])\n"
        "from gppvae_tpu_torch.train import train_cvae\n"
        f"train_cvae.main({[*GOLDEN_CLI, '--epochs', '1']!r}"
        " + ['--outdir', sys.argv[1] + '/cvae'])\n"
        "import validate_torch\n"
        "validate_torch.run_validation(epochs=1, pretrain=1, num_objects=12, device='cpu')\n"
        "sys.path.insert(0, 'tools')\n"
        "import bench_torch, torch_bench_diff, torch_observe_throughput\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'gppvae_tpu' or m.startswith('gppvae_tpu.'))\n"
        "assert not ref, ref\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert (tmp_path / "options" / "served" / "served.npz").is_file()
    # the exported program of the bfloat16 rbf-nystrom run answers as --state
    # does (within one bfloat16 rounding of a value below 1)
    np.testing.assert_allclose(
        np.load(tmp_path / "options" / "served_exe" / "served.npz")["images"],
        np.load(tmp_path / "options" / "served" / "served.npz")["images"], rtol=0, atol=1e-2)

    # and no source of the port (utils/prng.py included), nor chip_smoke.py,
    # validate_torch.py, bench_torch.py or the card's tools, names the JAX
    # package or a JAX library
    sources = [*sorted((REPO / "gppvae_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py",
               REPO / "validate_torch.py", REPO / "bench_torch.py",
               REPO / "tools" / "torch_observe_throughput.py",
               REPO / "tools" / "torch_bench_diff.py", REPO / "tools" / "torch_stream_cost.py"]
    found = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in ("gppvae_tpu", "jax", "flax", "optax")]
    assert len(sources) > 35 and not found, found
    assert {"train_cvae.py", "plots.py", "cvae.py", "profiling.py", "kernel_timing.py",
            "prng.py", "bench_torch.py", "torch_bench_diff.py"} <= {p.name for p in sources}


def test_guarded_adam_matches_optax_spike_guard():
    """Adam through the guard equals the JAX trainer's spike_guard(optax.adam)
    in float64: plain steps, a step above the clip, and a non-finite step
    that must leave params, moments and step count untouched."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)), "b": rng.standard_normal(5)}
    scale = [1.0, 1.0, 1e6, np.nan, 1.0, 0.5]  # a spike above clip 1e3, then NaN
    grads = [{k: rng.standard_normal(v.shape) * s for k, v in p0.items()} for s in scale]

    opt = jtrain.spike_guard(optax.adam(1e-2), 1e3)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    topt = GuardedAdam([tp[k] for k in sorted(tp)], lr=1e-2, clip_grad_norm=1e3)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        stepped = topt.step()
        assert stepped == bool(np.all([np.isfinite(v).all() for v in g.values()]))
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-12, atol=1e-14)
    assert topt.notfinite_count == int(state["notfinite_count"]) == 1
    assert int(topt.adam.state[tp["a"]]["step"]) == 5


@pytest.mark.parametrize("k", [2, 3])
def test_guarded_adam_accumulation_matches_optax_multisteps(k):
    """GuardedAdam(accum_steps=k) equals the JAX trainer's
    optax.MultiSteps(spike_guard(adam), k) in float64, call by call: the
    guard sees the mean of k gradients (a spike above the clip inside it),
    parameters stay put on the other k − 1 calls, and a NaN mini-step makes
    its k-th step skip (and, as optax keeps the NaN in its mean, every later
    one)."""
    rng = np.random.default_rng(k)
    p0 = {"a": rng.standard_normal((4, 3)), "b": rng.standard_normal(5)}
    scale = [1.0] * (2 * k) + [1e6] + [1.0] * (2 * k) + [np.nan] + [1.0] * (2 * k)
    grads = [{kk: rng.standard_normal(v.shape) * s for kk, v in p0.items()} for s in scale]

    opt = jtrain.make_optimizer(1e-2, 1e3, k)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = {kk: torch.nn.Parameter(torch.tensor(v)) for kk, v in p0.items()}
    topt = GuardedAdam([tp[kk] for kk in sorted(tp)], lr=1e-2, clip_grad_norm=1e3,
                       accum_steps=k)
    moved = []
    for g in grads:
        before = {kk: v.detach().clone() for kk, v in tp.items()}
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for kk, p in tp.items():
            p.grad = torch.tensor(g[kk])
        moved.append(topt.step())
        for kk in p0:
            np.testing.assert_allclose(tp[kk].detach().numpy(), np.asarray(jp[kk]),
                                       rtol=1e-12, atol=1e-14)
            assert moved[-1] or torch.equal(tp[kk].detach(), before[kk])
    nan_call = scale.index(np.nan)
    first_emit_after_nan = (nan_call // k + 1) * k - 1
    assert moved[:first_emit_after_nan] == [(i + 1) % k == 0 for i in range(first_emit_after_nan)]
    assert not any(moved[first_emit_after_nan:])
    skipped = len(scale) // k - first_emit_after_nan // k
    assert topt.notfinite_count == int(state.inner_opt_state["notfinite_count"]) == skipped
    assert topt.mini_step == int(state.mini_step) == len(scale) % k
    assert topt.steps == first_emit_after_nan // k


@pytest.mark.parametrize("requested", [-1, 1, 3])
@pytest.mark.parametrize("num_train,bs", [(5700, 128), (22800, 128), (66, 16), (100000, 64)])
def test_resolve_grad_accum_matches_jax(requested, num_train, bs):
    assert (resolve_grad_accum(requested, num_train, bs)
            == jtrain.resolve_grad_accum(requested, num_train, bs))
    with pytest.raises(ValueError):
        resolve_grad_accum(0, num_train, bs)


def _train(golden, **overrides):
    cfg = train_gppvae.GPPVAETrainConfig(**{**GOLDEN, **overrides})
    return train_gppvae.train_gppvae(golden["ds"], cfg, device="cpu",
                                     init_params=golden["init"], log=_Quiet())


def test_polish_switch_and_adam_restart(golden):
    """polish ≥ epochs: the whole run is float32 and equals a plain float32
    run bit for bit (no restart). polish 1 of 2: the first epoch runs
    bfloat16 (other numbers), the model ends float32, and both Adams
    restarted at the switch (their step counts hold one epoch)."""
    plain = _train(golden)
    whole = _train(golden, compute_dtype="bfloat16", polish_epochs=5)
    assert whole.model.dtype == torch.float32
    for a, b in zip(plain.history, whole.history):
        assert all(a[k] == b[k] for k in train_gppvae._METRIC_KEYS)
    for k, v in plain.model.state_dict().items():
        assert torch.equal(v, whole.model.state_dict()[k]), k
    for k, v in plain.gp_params.items():
        assert torch.equal(v, whole.gp_params[k]), k
    nb = -(-golden["num_train"] // GOLDEN["batch_size"])
    assert plain.optimizers["vae"].steps == plain.optimizers["gp"].steps == 2 * nb

    cross = _train(golden, compute_dtype="bfloat16", polish_epochs=1)
    assert cross.model.dtype == torch.float32
    assert cross.history[0]["loss"] != plain.history[0]["loss"]  # the bf16 bulk epoch
    assert all(np.isfinite(h[k]) for h in cross.history for k in train_gppvae._METRIC_KEYS)
    assert cross.optimizers["vae"].steps == cross.optimizers["gp"].steps == nb
    bulk = _train(golden, compute_dtype="bfloat16")
    assert bulk.model.dtype == torch.bfloat16
    assert bulk.optimizers["vae"].steps == 2 * nb


def test_sidecar_reload_reproduces_oos_mse(tmp_path):
    """config.json carries the dataset block of the JAX trainer's sidecar
    (train_gppvae.py:744-757); final_params.pt carries the GP params, the
    RFF draws and the Nyström landmarks, so that load_final rebuilds an
    rbf-nystrom run and reproduces its last oos_mse."""
    out = tmp_path / "run"
    res = train_gppvae.main([*GOLDEN_CLI, "--epochs", "1", "--xdim", "4", "--view_freqs", "2",
                             "--object_kernel", "rbf-nystrom", "--rff_features", "12",
                             "--nystrom_rank", "5", "--extra_effects", "view",
                             "--learn_sigma_y", "--outdir", str(out)])
    side = json.loads((out / "config.json").read_text())
    assert side["dataset"] == {"name": "rotated-digits-synthetic", "num_objects": 10,
                               "num_views": 8, "image_size": 32}
    assert side["object_kernel"] == "rbf-nystrom" and side["device"] == "cpu"
    back = train_gppvae.load_final(str(out), device="cpu")
    assert back.config == res.config
    d = back.data
    Z = encode_all(back.model, d["images_tr"], back.config.encode_chunk)
    _, oos = predict_heldout(back.model, back.gp_params, back.fixed_W, Z, d["d_tr"], d["q_tr"],
                             d["d_ho"], d["q_ho"], d["y_ho"], x_map=back.x_map,
                             extra_effects=back.config.extra_effects)
    assert float(oos) == pytest.approx(res.history[-1]["oos_mse"], rel=1e-6)
    saved = torch.load(out / train_gppvae.FINAL_PARAMS_FILE, weights_only=True)
    assert saved["object_kernel"]["nystrom_idx"].shape == (5,)
    assert set(saved["gp"]) == {"X", "W", "log_vs", "log_vn", "log_sy"}
