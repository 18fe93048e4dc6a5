"""The port's checkpoints, resume and epoch artifacts.

At the golden size of tests/test_resume.py (12 objects × 8 views, zdim 8,
features (8, 16)). For the port alone: an interrupted and resumed run equals
the uninterrupted one epoch by epoch on every history key (rtol 1e-5; the
CPU runs are in fact bit-equal) at the plain, boundary, mid-polish,
mid-accumulation, rbf-nystrom and 'dis' cases, with the port's own draws
(the JAX package's stream: epoch e's follow from the seed and e, so the
train state carries no generator). Against the JAX trainer: both resumed
at epoch 2 of 4 from the same state (the JAX state converted; the JAX
draws injected, or the port's own), every history key rtol 1e-4.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gppvae_tpu.checkpoint import load_train_state
from gppvae_tpu.data import build_rotated_digits
from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches
from gppvae_tpu.train.batching import epoch_keys
from gppvae_tpu_torch.checkpoint import CheckpointFormatError, load_tree, save_tree
from gppvae_tpu_torch.convert import train_state_from_jax
from gppvae_tpu_torch.train import train_gppvae as tg
from gppvae_tpu_torch.train import train_vae
from gppvae_tpu_torch.train.optim import GuardedAdam
from gppvae_tpu_torch.utils import NullLogger
from gppvae_tpu_torch.utils.profiling import TRACE_FILE
from _one_thread import one_thread  # noqa: F401

jtrain = importlib.import_module("gppvae_tpu.train.train_gppvae")
BASE = dict(mode="joint", zdim=8, epochs=4, batch_size=16, lr_gp=5e-3, obj_feature_dim=4,
            view_num_freqs=2, enc_features=(8, 16), dec_features=(16, 8))
RESUME_KEYS = ("loss", "recon_term", "gp_term", "pen_term", "gp_nll_full", "oos_mse")
# name → (config overrides, the states to resume from): 171 train rows,
# 11 steps per epoch, so accumulation over 2 leaves a half-filled window
# at every odd epoch's end
CASES = {
    "plain": (dict(), (2,)),
    "polish": (dict(compute_dtype="bfloat16", polish_epochs=2), (2, 3)),  # boundary, mid
    "grad_accum": (dict(grad_accum_steps=2), (1, 3)),
    "rbf-nystrom": (dict(object_kernel="rbf-nystrom", rff_features=16, nystrom_rank=6), (2,)),
    "dis": (dict(mode="dis"), (2,)),
}


@pytest.fixture(scope="module")
def ds():
    return build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)


def _train(ds, **kw):
    return tg.train_gppvae(ds, tg.GPPVAETrainConfig(**{**BASE, **kw}), device="cpu",
                           log=NullLogger())


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_trajectory_preserving(ds, tmp_path, case):
    kw, starts = CASES[case]
    out = str(tmp_path / "full")
    full = _train(ds, outdir=out, checkpoint_every=1, **kw)
    for start in starts:
        state = load_tree(f"{out}/state_{start:04d}")
        assert state["epoch"] == start
        if case == "grad_accum":  # between two Adam steps: the window is half full
            assert state["opt_vae"]["mini_step"] == 1 and state["opt_vae"]["acc"] is not None
        res = _train(ds, resume=f"{out}/state_{start:04d}", **kw)
        assert [h["epoch"] for h in res.history] == list(range(start, 4))
        for h_res, h_full in zip(res.history, full.history[start:]):
            for key in RESUME_KEYS:
                np.testing.assert_allclose(
                    h_res[key], h_full[key], rtol=1e-5,
                    err_msg=f"{case}: epoch {h_full['epoch']} {key!r} diverged on resume "
                            f"from state_{start:04d}")
        if case == "polish":
            # resumed at the switch both Adams restart; inside the window they
            # do not: either way they count the float32 epochs only
            assert res.model.dtype == torch.float32
            assert res.optimizers["vae"].steps == full.optimizers["vae"].steps
        if case == "rbf-nystrom":  # the run's own landmarks and draws, not fresh ones
            assert torch.equal(state["object_kernel"]["nystrom_idx"],
                               load_tree(f"{out}/final_state")["object_kernel"]["nystrom_idx"])
    # final_state continues a run to a later --epochs
    more = _train(ds, resume=f"{out}/final_state", **{**kw, "epochs": 5})
    assert [h["epoch"] for h in more.history] == [4]


def test_generator_state_round_trip(ds, tmp_path):
    """No generator state travels: the train state names its stream, and
    epoch 3 of a resume draws what the uninterrupted run drew. A state
    written before the port drew the JAX package's stream (it holds the
    torch.Generator's state) is refused by name before any work, rather
    than continued on other draws."""
    out = str(tmp_path / "run")
    full = _train(ds, outdir=out, checkpoint_every=2)
    state = load_tree(f"{out}/state_0003")
    assert state["stream"] == tg.STREAM and "generator" not in state
    res = _train(ds, resume=f"{out}/state_0003")
    assert res.history[0]["loss"] == full.history[3]["loss"]
    old = {k: v for k, v in state.items() if k != "stream"}
    old["generator"] = torch.Generator().manual_seed(0).get_state()
    save_tree(str(tmp_path / "old"), old)
    with pytest.raises(ValueError, match="torch.Generator"):
        _train(ds, resume=str(tmp_path / "old"), outdir=str(tmp_path / "never"))
    assert not os.path.exists(tmp_path / "never")


def test_guarded_adam_state_dict_round_trip():
    """state_dict() / load_state_dict() carry Adam's moments, the position
    inside an accumulation window, its running mean and the counters: two
    optimizers fed the same gradients stay equal after a mid-window copy."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((4, 3)) * s for s in (1.0, 1.0, np.nan, 1.0, 0.5, 2.0, 1.0)]

    def make():
        p = torch.nn.Parameter(torch.ones(4, 3, dtype=torch.float64))
        return p, GuardedAdam([p], lr=1e-2, clip_grad_norm=1e3, accum_steps=2)

    pa, a = make()
    for g in grads[:3]:
        pa.grad = torch.tensor(g)
        a.step()
    saved = a.state_dict()
    assert saved["mini_step"] == 1 and saved["steps"] == 1
    pb, b = make()
    with torch.no_grad():
        pb.copy_(pa)
    b.load_state_dict(saved)
    for g in grads[3:]:
        for p, opt in ((pa, a), (pb, b)):
            p.grad = torch.tensor(g)
            opt.step()
    assert torch.equal(pa, pb) or (torch.isnan(pa) == torch.isnan(pb)).all()
    assert (a.steps, a.mini_step, a.notfinite_count) == (b.steps, b.mini_step, b.notfinite_count)
    assert b.notfinite_count >= 1  # the NaN mean is carried, as optax carries it


@pytest.mark.parametrize("fault,match", [
    ("version", "format_version=99"), ("missing", "no format sidecar"),
    ("unreadable", "unreadable format sidecar"),
])
def test_resume_format_errors_before_any_training(ds, tmp_path, monkeypatch, fault, match):
    out = str(tmp_path / "run")
    _train(ds, outdir=out, epochs=1)
    sidecar = f"{out}/final_state.format.json"
    assert json.load(open(sidecar))["format_version"] == 1
    if fault == "version":
        open(sidecar, "w").write('{"format_version": 99}')
    elif fault == "missing":
        os.remove(sidecar)
    else:
        open(sidecar, "w").write('{"format_ver')

    def no_encode(self):
        raise AssertionError("trained before the state was refused")

    monkeypatch.setattr(tg._Loop, "encode", no_encode)
    with pytest.raises(CheckpointFormatError, match=match):
        _train(ds, resume=f"{out}/final_state")
    # a tree of the format that is no train state (here the VAE's own final_state)
    save_tree(f"{out}/other", {"vae": {}, "opt": {}, "epoch": 1})
    with pytest.raises(CheckpointFormatError, match="not a train state"):
        _train(ds, resume=f"{out}/other")


@pytest.mark.parametrize("change,names", [
    (dict(zdim=6), ["zdim"]),
    (dict(mode="dis"), ["mode"]),
    (dict(enc_features=(8, 8), learn_sigma_y=True), ["enc_features", "learn_sigma_y"]),
    (dict(extra_effects=("object",)), ["extra_effects"]),
])
def test_resume_config_mismatch_names_the_field(ds, tmp_path, change, names):
    """A state written under a config that shapes its tensors otherwise is
    refused by field name, not by a size mismatch from load_state_dict."""
    out = str(tmp_path / "run")
    _train(ds, outdir=out, epochs=1)
    with pytest.raises(ValueError, match="another configuration") as e:
        _train(ds, resume=f"{out}/final_state", **change)
    assert all(f"{n}:" in str(e.value) for n in names)
    other = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=0)
    with pytest.raises(ValueError, match="num_objects"):
        _train(other, resume=f"{out}/final_state")


def test_epoch_artifacts_and_cli_flags(ds, tmp_path, monkeypatch):
    """panel_NNNN.png on the cadence and the last epoch, state_NNNN on the
    cadence but the last, final_state and final_params.pt at the end; the
    CLI's defaults are the JAX CLI's (--panel_every 10, --checkpoint_every 0)
    and every new flag reaches the config."""
    out = tmp_path / "run"
    _train(ds, outdir=str(out), epochs=5, panel_every=2, checkpoint_every=2)
    files = set(os.listdir(out))
    assert {f for f in files if f.startswith("panel_")} == {
        "panel_0000.png", "panel_0002.png", "panel_0004.png"}
    assert {f for f in files if f.startswith("state_") and not f.endswith(".json")} == {
        "state_0001", "state_0003"}  # epochs 0 and 2 done; epoch 4 is the last
    assert {"final_state", "final_state.format.json", "final_params.pt"} <= files
    assert (out / "panel_0000.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # 4 rows of 8 images: train, reconstructions, held-out, predictions
    import struct

    w, h = struct.unpack(">II", (out / "panel_0000.png").read_bytes()[16:24])
    assert (w, h) == (8 * 34 + 2, 4 * 34 + 2)

    captured = {}
    monkeypatch.setattr(tg, "train_gppvae",
                        lambda ds, config, **kw: captured.update(config=config))
    small = ["--data", "synthetic", "--num_objects", "6", "--num_views", "4", "--device", "cpu"]
    tg.main(small)
    c = captured["config"]
    assert (c.panel_every, c.checkpoint_every, c.resume, c.profile_dir) == (10, 0, None, None)
    tg.main([*small, "--panel_every", "3", "--checkpoint_every", "7", "--resume", "a/state_0007",
             "--profile_dir", "trace"])
    c = captured["config"]
    assert (c.panel_every, c.checkpoint_every, c.resume, c.profile_dir) == (
        3, 7, "a/state_0007", "trace")


def test_train_vae_artifacts(tmp_path):
    """train_vae's pair: panel_NNNN.png (8 validation rows over their
    reconstructions), vae_weights_NNNN.pt on the cadence but the last epoch,
    final_state; a panel does not move the training stream."""
    cli = ["--data", "synthetic", "--num_objects", "10", "--num_views", "8", "--zdim", "6",
           "--bs", "16", "--enc_features", "8,16", "--dec_features", "16,8", "--device", "cpu",
           "--epochs", "3"]
    out = tmp_path / "vae"
    res = train_vae.main([*cli, "--outdir", str(out), "--panel_every", "1",
                          "--checkpoint_every", "2"])
    files = set(os.listdir(out))
    assert {"panel_0000.png", "panel_0001.png", "panel_0002.png", "vae_weights_0000.pt",
            "vae_weights.pt", "final_state", "final_state.format.json"} <= files
    assert "vae_weights_0002.pt" not in files  # the last epoch writes vae_weights.pt
    state = load_tree(str(out / "final_state"))
    assert state["epoch"] == 3 and set(state) == {"vae", "opt", "epoch"}
    for k, v in res.model.state_dict().items():
        assert torch.equal(state["vae"][k], v)
    import struct

    w, h = struct.unpack(">II", (out / "panel_0000.png").read_bytes()[16:24])
    n_val = min(8, len(build_rotated_digits("synthetic", num_objects=10, num_views=8).val_idx))
    assert (w, h) == (n_val * 34 + 2, 2 * 34 + 2)  # up to 8 validation rows, 2 panel rows
    plain = train_vae.main([*cli, "--outdir", str(tmp_path / "plain"), "--panel_every", "0"])
    assert [h["loss"] for h in plain.history] == [h["loss"] for h in res.history]
    assert not any(f.startswith("panel_") for f in os.listdir(tmp_path / "plain"))


def test_profile_dir_writes_a_trace(ds, tmp_path):
    """profile_dir wraps the epochs in torch.profiler and leaves a Chrome
    trace (the twin of the JAX trainer's jax.profiler trace), in which the
    port's spans are user annotations: the phases and each Phase C step."""
    import gzip

    _train(ds, epochs=1, profile_dir=str(tmp_path / "trace"))
    with gzip.open(tmp_path / "trace" / TRACE_FILE, "rt") as f:
        trace = json.load(f)
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert any("conv" in (n or "") for n in names)
    spans = {ev["name"] for ev in trace["traceEvents"] if ev.get("cat") == "user_annotation"}
    assert {"C_minibatch", "C.step", "C.forward", "C.backward", "C.optim",
            "sync.plan"} <= spans


def _jax_plan(rng, epoch, num_train, bs, zdim):
    key = epoch_keys(rng, epoch, 1)[0]
    batches, weights = jax_epoch_batches(key, num_train, bs)
    step_keys = jax.random.split(jax.random.fold_in(key, 1), batches.shape[0])
    eps = jnp.stack([jax.random.normal(k, (bs, zdim), jnp.float32) for k in step_keys])
    return [torch.from_numpy(np.array(a)) for a in (batches, weights, eps)]


@pytest.fixture(scope="module")
def jax_interrupted(ds, tmp_path_factory):
    """The JAX trainer stopped after epoch 2 of 4: its final_state restored as
    its trainer restores it, and that state carried across whole by
    convert.train_state_from_jax (numpy trees in, the port's tree out)."""
    jout = str(tmp_path_factory.mktemp("jax") / "run")
    jtrain.train_gppvae(ds, jtrain.GPPVAETrainConfig(**dict(BASE, epochs=2), outdir=jout),
                        log=NullLogger())
    jcfg4 = jtrain.GPPVAETrainConfig(**BASE)
    _, params, fixed_W, _, rng, _ = jtrain._setup(ds, jcfg4, None, None)
    jopts = {"ov_state": jtrain.make_optimizer(jcfg4.lr_vae, jcfg4.clip_grad_norm, 1),
             "og_state": jtrain.make_optimizer(jcfg4.lr_gp, jcfg4.clip_grad_norm, 1)}
    jstate = load_train_state(jout + "/final_state", {
        "params": params, "ov_state": jopts["ov_state"].init(params["vae"]),
        "og_state": jopts["og_state"].init(params["gp"]), "epoch": 0})
    assert int(jstate["epoch"]) == 2

    cfg = tg.GPPVAETrainConfig(**BASE)
    model, gp_params, fixed_W, data, n = tg._setup(ds, cfg, torch.device("cpu"))
    loop = tg._Loop(model, gp_params, fixed_W, data, n, cfg)

    def adam_np(jopt_state):
        adam = jopt_state["inner"][0]  # optax ScaleByAdamState
        return {"mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
                "count": np.asarray(adam.count)}

    state = train_state_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), adam_np(jstate["ov_state"]),
        adam_np(jstate["og_state"]), int(jstate["epoch"]),
        template=tg._train_state(loop, None, 0, tg._shape_config(cfg, ds)))
    assert state["epoch"] == 2 and state["opt_vae"]["steps"] == state["opt_gp"]["steps"] > 0
    jres = jtrain.train_gppvae(
        ds, jtrain.GPPVAETrainConfig(**BASE, resume=jout + "/final_state"), log=NullLogger())
    assert [h["epoch"] for h in jres.history] == [2, 3]
    return dict(jout=jout, jstate=jstate, rng=rng, state=state, n=n, jres=jres)


@pytest.mark.parametrize("draws", ["injected", "own"])
def test_resumed_run_matches_jax_resumed_run(ds, tmp_path, jax_interrupted, draws):
    """The JAX trainer interrupted at epoch 2 and resumed to 4, against the
    port resumed at epoch 2 from that same state (params and both Adams'
    moments converted), with the JAX draws injected or drawing its own:
    every history key of epochs 2 and 3, rtol 1e-4."""
    ji = jax_interrupted
    save_tree(str(tmp_path / "converted"), ji["state"])
    injected = None
    if draws == "injected":
        def injected(epoch):
            return [t.long() if i == 0 else t
                    for i, t in enumerate(_jax_plan(ji["rng"], epoch, ji["n"], 16, 8))]
    res = tg.train_gppvae(
        ds, tg.GPPVAETrainConfig(**BASE, resume=str(tmp_path / "converted")), device="cpu",
        draws=injected, log=NullLogger())
    assert [h["epoch"] for h in res.history] == [2, 3]
    for ours, theirs in zip(res.history, ji["jres"].history):
        for k in tg._METRIC_KEYS:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)


def test_converted_jax_state_is_generated_from_and_served(ds, tmp_path, jax_interrupted):
    """The converted train state through the port's CLIs: `generate
    --export_server` folds it, `serve --state` answers the held-out cells;
    images and variances equal the JAX package's serving functions on the
    JAX state (rtol 1e-4, atol 1e-5)."""
    from gppvae_tpu.eval import serving as jserving
    from gppvae_tpu.models import VAE as JVAE
    from gppvae_tpu_torch.eval import generate, serving

    ji = jax_interrupted
    run = tmp_path / "run"
    run.mkdir()
    save_tree(str(run / "state_0002"), ji["state"])
    (run / "config.json").write_text(json.dumps({
        **{k: BASE[k] for k in ("zdim", "enc_features", "dec_features")}, "seed": 0,
        "data": "synthetic", "dataset": {"num_objects": 12, "num_views": 8}}))
    srv = str(tmp_path / "m.srv")
    generate.main(["--state", str(run / "state_0002"), "--device", "cpu", "--export_server", srv])
    d_ho, q_ho = ds.object_ids[ds.heldout_idx], ds.view_ids[ds.heldout_idx]
    serving.main(["--state", srv, "--device", "cpu", "--var", "--outdir", str(tmp_path / "out"),
                  "--requests", ",".join(f"{a}:{b}" for a, b in zip(d_ho, q_ho))])
    served = np.load(tmp_path / "out" / "served.npz")
    state, _ = serving.load_server_state(srv)

    jmodel = JVAE(zdim=8, image_shape=tuple(ds.image_shape), enc_features=(8, 16),
                  dec_features=(16, 8))
    tr = ds.train_idx
    jsrv = jserving.build_server_state(
        jmodel, ji["jstate"]["params"], None, jnp.asarray(ds.images[tr]),
        jnp.asarray(ds.object_ids[tr]), jnp.asarray(ds.view_ids[tr]))
    y, var = jserving.predict_images(jmodel, jsrv, jnp.asarray(d_ho), jnp.asarray(q_ho),
                                     return_var=True)
    np.testing.assert_allclose(served["images"], np.asarray(y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.core.M.numpy(), np.asarray(jsrv.core.M), rtol=1e-3, atol=1e-5)
    port_var = serving.predict_images(
        serving._model_from_meta(serving.load_server_state(srv)[1], state.vae_params, "cpu"),
        state, torch.as_tensor(d_ho, dtype=torch.int64), torch.as_tensor(q_ho, dtype=torch.int64),
        return_var=True)[1]
    np.testing.assert_allclose(port_var.numpy(), np.asarray(var), rtol=1e-4, atol=1e-5)
