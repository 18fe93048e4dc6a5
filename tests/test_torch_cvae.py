"""The port's CVAE baseline (models/cvae.py, train/train_cvae.py) against the
JAX package's.

Weights come from a flax init, converted with
gppvae_tpu_torch.convert.cvae_state_dict_from_flax; inputs are numpy arrays
from a seed. float32 encode / decode: atol 1e-5 (rtol 1e-4); the subpixel
decoder 1e-5 of max |·| and bfloat16 compute 2e-2 of max |flax|, the bounds
tests/test_torch_models.py holds the VAE to. The 2-epoch `train_cvae`
trajectory at the golden size (10 objects × 8 views, zdim 6, features
(8, 16)) starts from the JAX trainer's own init and is fed its own draws,
rebuilt from its keys: every history key rtol 1e-4.
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gppvae_tpu.data import build_rotated_digits
from gppvae_tpu.models import CVAE as FlaxCVAE
from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches
from gppvae_tpu.train.batching import epoch_keys
from gppvae_tpu_torch.checkpoint import load_tree
from gppvae_tpu_torch.convert import cvae_state_dict_from_flax
from gppvae_tpu_torch.models import CVAE
from gppvae_tpu_torch.train import train_cvae as tc
from gppvae_tpu_torch.utils import NullLogger
from _one_thread import one_thread  # noqa: F401

jcvae = importlib.import_module("gppvae_tpu.train.train_cvae")
SHAPE, Q = (32, 32, 1), 8
WIDTHS = {
    "full": dict(zdim=16, enc=(32, 64, 128), dec=(128, 64, 32)),
    "golden": dict(zdim=6, enc=(8, 16), dec=(16, 8)),
}
BF16_REL_BOUND = 2e-2  # as tests/test_torch_models.py
GOLDEN = dict(zdim=6, epochs=2, batch_size=16, lr=1e-3, seed=7,
              enc_features=(8, 16), dec_features=(16, 8))


def _pair(width, dtype="float32", upsample="resize", seed=0):
    w = WIDTHS[width]
    fm = FlaxCVAE(zdim=w["zdim"], image_shape=SHAPE, num_views=Q, enc_features=w["enc"],
                  dec_features=w["dec"], dtype=getattr(jnp, dtype), upsample=upsample)
    fp = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SHAPE)), jnp.zeros((1,), jnp.int32),
                 jax.random.PRNGKey(seed + 1))
    tm = CVAE(w["zdim"], SHAPE, Q, w["enc"], w["dec"], upsample, dtype=getattr(torch, dtype))
    tm.load_state_dict(cvae_state_dict_from_flax(jax.tree.map(np.asarray, fp)))
    return fm, fp, tm


def _inputs(zdim, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, *SHAPE)).astype(np.float32),
            rng.standard_normal((n, zdim)).astype(np.float32),
            rng.integers(0, Q, size=n).astype(np.int32))


def _both(fm, fp, tm, y, z, q):
    mu, logvar = fm.apply(fp, jnp.asarray(y), jnp.asarray(q), method=FlaxCVAE.encode)
    logits = fm.apply(fp, jnp.asarray(z), jnp.asarray(q), method=FlaxCVAE.decode)
    tq = torch.from_numpy(q).long()
    with torch.no_grad():
        tmu, tlogvar = tm.encode(torch.from_numpy(y), tq)
        tlogits = tm.decode(torch.from_numpy(z), tq)
    return ((tmu, mu), (tlogvar, logvar), (tlogits, logits))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_cvae_forward_matches_flax(width):
    fm, fp, tm = _pair(width)
    pairs = _both(fm, fp, tm, *_inputs(WIDTHS[width]["zdim"]))
    assert pairs[2][0].shape == (5, *SHAPE)
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    # the first encoder conv takes C + Q channels, the first decoder dense zdim + Q
    sd = tm.state_dict()
    assert sd["encoder.convs.0.weight"].shape[1] == SHAPE[2] + Q
    assert sd["decoder.dense.weight"].shape[1] == WIDTHS[width]["zdim"] + Q


def test_cvae_subpixel_matches_flax():
    fm, fp, tm = _pair("golden", upsample="subpixel")
    for a, b in _both(fm, fp, tm, *_inputs(6)):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("upsample", ["resize", "subpixel"])
def test_cvae_bf16_matches_flax(upsample):
    fm, fp, tm = _pair("golden", dtype="bfloat16", upsample=upsample, seed=2)
    for a, b in _both(fm, fp, tm, *_inputs(6, seed=9)):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert _rel(a, b) <= BF16_REL_BOUND
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_cvae_view_conditioning_matters():
    """Decoding one latent, and encoding one image, under two views must
    differ: both conditioning paths are live."""
    model = CVAE(4, SHAPE, Q, (8,), (8,), key=0)
    z, y = torch.ones(2, 4), torch.rand(2, *SHAPE, generator=torch.Generator().manual_seed(1))
    q0, q3 = torch.tensor([0, 0]), torch.tensor([3, 3])
    with torch.no_grad():
        assert float((model.decode(z, q0) - model.decode(z, q3)).abs().max()) > 1e-4
        assert float((model.encode(y, q0)[0] - model.encode(y, q3)[0]).abs().max()) > 1e-4


def _jax_draws(rng, num_train, bs, zdim):
    """draws(epoch) of the JAX trainer (train_cvae.py:126, :152-153)."""
    def draws(epoch):
        key = epoch_keys(rng, epoch, 1)[0]
        batches, weights = jax_epoch_batches(key, num_train, bs)
        step_keys = jax.random.split(jax.random.fold_in(key, 1), batches.shape[0])
        eps = jnp.stack([jax.random.normal(k, (bs, zdim), jnp.float32) for k in step_keys])
        b, w, e = (torch.from_numpy(np.array(a)) for a in (batches, weights, eps))
        return b.long(), w, e

    return draws


@functools.cache
def _jax_run(case):
    """(dataset, the JAX trainer's 2-epoch run of a case), once per process."""
    extra = dict(dec_upsample="subpixel") if case == "subpixel" else {}
    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=7)
    return ds, jcvae.train_cvae(ds, jcvae.CVAETrainConfig(**GOLDEN, **extra), log=NullLogger())


@pytest.mark.parametrize("case", ["float32", "subpixel"])
def test_two_epoch_trajectory_matches_jax(case, tmp_path):
    extra = dict(dec_upsample="subpixel") if case == "subpixel" else {}
    ds, jres = _jax_run(case)

    # the JAX trainer's own init and keys (train_cvae.py:84-85, :97)
    rng, init_key, sample_key = jax.random.split(jax.random.PRNGKey(GOLDEN["seed"]), 3)
    tr = ds.train_idx
    params = jres.model.init(init_key, jnp.asarray(ds.images[tr][:1]),
                             jnp.asarray(ds.view_ids[tr][:1]), sample_key)
    init = cvae_state_dict_from_flax(jax.tree.map(np.asarray, params))
    res = tc.train_cvae(ds, tc.CVAETrainConfig(**GOLDEN, **extra, outdir=str(tmp_path)),
                        device="cpu", init_params=init,
                        draws=_jax_draws(rng, len(tr), 16, 6), log=NullLogger())
    assert len(res.history) == len(jres.history) == 2
    keys = ("loss", "recon_term", "kl_term", "mse", "oos_mse")
    assert set(res.history[0]) == set(jres.history[0]) == {"driver", "epoch", "sec_epoch", *keys}
    for ours, theirs in zip(res.history, jres.history):
        assert ours["driver"] == theirs["driver"] == "train_cvae"
        for k in keys:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)
    # artifacts (train_cvae.py:195-214)
    assert {tc.WEIGHTS_FILE, "final_state", "final_state.format.json",
            "oos_panel.png"} <= set(os.listdir(tmp_path))
    state = load_tree(str(tmp_path / "final_state"))
    assert state["epoch"] == 2 and set(state) == {"cvae", "opt", "epoch"}
    saved = torch.load(tmp_path / tc.WEIGHTS_FILE, weights_only=True)
    for k, v in res.model.state_dict().items():
        assert torch.equal(saved[k], v) and torch.equal(state["cvae"][k], v)


def test_two_epoch_trajectory_matches_jax_without_injection():
    """train_cvae from the seed alone: flax's CVAE.init from the JAX
    trainer's init key, its plans and ε (the JAX package's stream). No draws
    injected, no weights converted: every history key rtol 1e-4."""
    ds, jres = _jax_run("float32")
    res = tc.train_cvae(ds, tc.CVAETrainConfig(**GOLDEN), device="cpu", log=NullLogger())
    assert len(res.history) == len(jres.history) == 2
    for ours, theirs in zip(res.history, jres.history):
        for k in ("loss", "recon_term", "kl_term", "mse", "oos_mse"):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)


def test_cvae_trains_seeded_and_oos_improves(tmp_path):
    """The port's own seeded draws (tests/test_train_cvae.py's run): the loss
    and the out-of-sample MSE fall over 6 epochs."""
    ds = build_rotated_digits("synthetic", num_objects=16, num_views=8, seed=0)
    cfg = tc.CVAETrainConfig(zdim=8, epochs=6, batch_size=16, lr=1e-3, seed=0,
                             enc_features=(8, 16), dec_features=(16, 8))
    h = tc.train_cvae(ds, cfg, device="cpu", log=NullLogger()).history
    assert np.isfinite([r["loss"] for r in h]).all()
    assert h[-1]["loss"] < h[0]["loss"] and h[-1]["oos_mse"] < h[0]["oos_mse"]
    with pytest.raises(ValueError, match="exceeds train set"):
        tc.train_cvae(ds, tc.CVAETrainConfig(batch_size=4096), device="cpu", log=NullLogger())


def test_cvae_cli_flags_reach_config(monkeypatch):
    """Every train-cvae flag lands in CVAETrainConfig; --epochs_per_dispatch
    is not taken (the port runs one epoch per iteration); the default
    device is cuda."""
    captured = {}
    monkeypatch.setattr(tc, "train_cvae",
                        lambda ds, config, **kw: captured.update(config=config, **kw))
    flags = ["--data", "synthetic", "--num_objects", "6", "--num_views", "4",
             "--epochs", "2", "--zdim", "5", "--bs", "8", "--lr", "3e-4",
             "--beta_kl", "0.5", "--sat_penalty", "0.0", "--dtype", "bfloat16",
             "--dec_upsample", "subpixel", "--enc_features", "8,16", "--dec_features", "16,8",
             "--sigma_y", "0.2", "--seed", "3", "--outdir", "cli_cfg_test_cvae"]
    tc.main([*flags, "--device", "cpu"])
    c = captured["config"]
    assert c.zdim == 5 and c.batch_size == 8 and c.lr == 3e-4 and c.epochs == 2
    assert c.beta_kl == 0.5 and c.sat_penalty == 0.0 and c.sigma_y == 0.2 and c.seed == 3
    assert c.compute_dtype == "bfloat16" and c.dec_upsample == "subpixel"
    assert c.enc_features == (8, 16) and c.dec_features == (16, 8)
    assert c.outdir == "cli_cfg_test_cvae" and captured["device"] == torch.device("cpu")
    with pytest.raises(SystemExit):
        tc.main([*flags, "--device", "cpu", "--epochs_per_dispatch", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tc.main(flags)
