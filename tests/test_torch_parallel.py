"""The port's data parallelism (gppvae_tpu_torch/parallel/) against the JAX
package's 1-D mesh.

The port's ranks are torch.distributed processes on the CPU over gloo,
started once for this module (a pool of 2 ranks, and one of 4 for the
3-row grid) and given one function of gppvae_tpu_torch.parallel.dryrun per
case: the ranks never import jax. The JAX side runs on conftest's 8 virtual
CPU devices under make_mesh(k), fed nothing the port does not also get: the
same numpy inputs, the JAX trainer's own initial params and its draws
(tests/test_torch_train.py:94-171). Tolerances (float32):
  (i)   factor_prep on 2 ranks against `_factor_prep_shard_map` in Pallas
        interpret mode, values and gradients rtol 3e-4 / atol 1e-3
        (tests/test_parallel.py:90-95: partial sums reorder the N-reduction);
  (ii)  GPPVAE-joint, 2 epochs, on k ranks against train_gppvae(mesh=
        make_mesh(k)) and against the port's own single-process run: every
        history key rtol 1e-4. bf16 + polish: rtol 2e-3 against the port's
        single-process run (tests/test_parallel.py:253-289's bound for the
        mesh against one device) and 5e-3 against the JAX mesh: the two
        packages round bfloat16 at other places, and their single-process
        runs of this case already differ by 2.1e-3 (pen_term, epoch 0);
  (iii) train_vae on 2 ranks against train_vae(mesh=make_mesh(2)): rtol 1e-4;
  (iv)  the DP fold, predict_images and observe against the single-device
        JAX values of tests/test_parallel.py:169-222: rtol 1e-5 / atol 1e-6;
  (v)   the collectives of an epoch are the same at two dataset sizes, none
        larger than the gradient all-reduce;
  (vi)  the parameters are bit-equal on every rank after every epoch (the
        trainer checks it; the digests here), and the check catches a rank
        that differs;
  and a 2-rank run's final_state resumed in one process equals the 2-rank run
  continued (and the other way round), rtol 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gppvae_tpu import ops as jops
from gppvae_tpu.data import build_rotated_digits as jax_digits
from gppvae_tpu.parallel import make_mesh, shard_rows, trim_to_multiple
from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches
from gppvae_tpu.train.batching import epoch_keys
from gppvae_tpu.utils.metrics import NullLogger
from gppvae_tpu_torch import parallel
from gppvae_tpu_torch.convert import flax_to_state_dict
from gppvae_tpu_torch.parallel import dryrun

jtrain = importlib.import_module("gppvae_tpu.train.train_gppvae")
jtrain_vae = importlib.import_module("gppvae_tpu.train.train_vae")

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")

SMALL = dict(mode="joint", zdim=8, epochs=2, batch_size=16, obj_feature_dim=4,
             view_num_freqs=2, enc_features=(8, 16), dec_features=(16, 8))
# (ii): (grid, config overrides, ranks, rtol against one process, rtol against
# the JAX mesh); the grids of tests/test_parallel.py, except that 11 × 8 (73
# training rows) takes the place of 13 × 8 (86), which 2 ranks divide
CASES = {
    "odd_n": ((11, 8), {}, 2, 1e-4, 1e-4),
    "grad_accum": ((16, 8), {"grad_accum_steps": 2}, 2, 1e-4, 1e-4),
    "refresh_mid_epoch": ((16, 8), {"refresh_every_steps": 3}, 2, 1e-4, 1e-4),
    "polish_tail": ((16, 8), {"compute_dtype": "bfloat16", "polish_epochs": 1}, 2, 2e-3, 5e-3),
    "three_rows_four_ranks": ((3, 2), {"batch_size": 2, "view_num_freqs": 1}, 4, 1e-4, 1e-4),
}


@pytest.fixture(scope="module")
def pools():
    """Rank pools by world size, started on first use (again after a rank's
    failure closed one), closed at the end."""
    started = {}

    def get(world):
        if world not in started or started[world].closed:
            started[world] = parallel.RankPool(world, backend="gloo", device="cpu")
        return started[world]

    yield get
    for pool in started.values():
        pool.close()


def _data(grid):
    return dict(source="synthetic", num_objects=grid[0], num_views=grid[1], seed=0)


def _jax_plan(rng, epoch, num_train, bs, zdim):
    """The JAX trainer's draws for one epoch (train_gppvae.py:456,507-508)."""
    key = epoch_keys(rng, epoch, 1)[0]
    batches, weights = jax_epoch_batches(key, num_train, bs)
    step_keys = jax.random.split(jax.random.fold_in(key, 1), batches.shape[0])
    eps = jnp.stack([jax.random.normal(k, (bs, zdim), jnp.float32) for k in step_keys])
    return [np.asarray(a) for a in (batches, weights, eps)]


def _jax_case(case):
    grid, over, world, *_ = CASES[case]
    ds = jax_digits("synthetic", num_objects=grid[0], num_views=grid[1], seed=0)
    return ds, jtrain.GPPVAETrainConfig(**{**SMALL, **over}), world


def _jax_inputs(case):
    """The port's inputs of a case: the JAX trainer's initial params and its
    draws by epoch."""
    ds, jcfg, _ = _jax_case(case)
    _, params, _, _, rng, n = jtrain._setup(ds, jcfg, None, None)
    init = {"vae": {k: v.numpy() for k, v in
                    flax_to_state_dict(jax.tree.map(np.asarray, params["vae"])).items()},
            "gp": {k: np.asarray(v) for k, v in params["gp"].items()}}
    return init, [_jax_plan(rng, e, n, jcfg.batch_size, jcfg.zdim) for e in range(jcfg.epochs)]


def _jax_mesh_history(case):
    ds, jcfg, world = _jax_case(case)
    return jtrain.train_gppvae(ds, jcfg, mesh=make_mesh(world), log=NullLogger()).history


VAE_CONFIG = dict(zdim=8, epochs=2, batch_size=16, enc_features=(8, 16), dec_features=(16, 8))
VAE_GRID = (13, 7)  # 91 images: an odd split


def _jax_vae_history():
    ds = jax_digits("synthetic", num_objects=VAE_GRID[0], num_views=VAE_GRID[1], seed=0)
    cfg = jtrain_vae.VAETrainConfig(**VAE_CONFIG)
    return jtrain_vae.train_vae(ds, cfg, mesh=make_mesh(2), log=NullLogger()).history


@pytest.mark.parametrize("case", list(CASES))
def test_gppvae_ranks_match_jax_mesh(pools, case):
    """(ii) and (vi): the k-rank trajectory equals the JAX mesh's and the
    port's single-process one; every rank has the same history and the same
    parameter bits."""
    grid, over, world, rtol_one, rtol_jax = CASES[case]
    init, draws = _jax_inputs(case)
    config = {**SMALL, **over}
    ranks = pools(world).run(dryrun.train_gppvae_rank, _data(grid), config, init, draws)
    one = dryrun.train_gppvae(_data(grid), config, "cpu", init_params=init, draws=draws)
    hist = _jax_mesh_history(case)
    assert len(ranks) == world and len(hist) == 2
    for r in ranks:
        assert [h["epoch"] for h in r["history"]] == [0, 1]
        for ours, jax_h, one_h in zip(r["history"], hist, one["history"]):
            for k in dryrun.KEYS:
                where = f"{case}: {k} epoch {ours['epoch']}"
                np.testing.assert_allclose(ours[k], jax_h[k], rtol=rtol_jax, atol=1e-6,
                                           err_msg=f"{where}, against the JAX mesh")
                np.testing.assert_allclose(ours[k], one_h[k], rtol=rtol_one, atol=1e-6,
                                           err_msg=f"{where}, against one process")
        # reduced on every rank alike: the same bits
        assert all(a[k] == b[k] for a, b in zip(r["history"], ranks[0]["history"])
                   for k in dryrun.KEYS)
    assert len({r["digest"] for r in ranks}) == 1
    assert set(ranks[0]["launches"].values()) == {0}  # the CPU: plain versions only


def test_factor_prep_ranks_match_shard_map(pools, monkeypatch):
    """(i) ops.factor_prep(group=) on 2 ranks against the JAX package's
    Pallas kernel per shard + psum (interpret mode), N = 256 and N = 255
    (one zero row pads the JAX side to the mesh; the port splits 128 + 127)."""
    monkeypatch.setenv("GPPVAE_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    mesh = make_mesh(2)

    def loss(u, z):
        g, utz, zn = jops.factor_prep(u, z)
        return jnp.sum(g * g) + jnp.sum(utz) + zn

    for n in (256, 255):
        U = rng.standard_normal((n, 24)).astype(np.float32)
        Z = rng.standard_normal((n, 8)).astype(np.float32)
        pad = (-n) % 2
        Up, Zp = (jnp.asarray(np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)]))
                  for a in (U, Z))
        Us, Zs = shard_rows(mesh, Up, Zp)
        with jops.use_backend("pallas"), jops.use_mesh(mesh):
            want = jax.jit(lambda u, z: jops.factor_prep(u, z))(Us, Zs)
            dU, dZ = jax.jit(jax.grad(loss, argnums=(0, 1)))(Us, Zs)
        ranks = pools(2).run(dryrun.factor_prep_rank, U, Z)
        for name, w in zip(("G", "UtZ", "zn"), want):
            for r in ranks:  # replicated
                np.testing.assert_allclose(r[name], np.asarray(w), rtol=3e-4, atol=1e-3,
                                           err_msg=f"N={n} {name}")
        for name, w in (("dU", dU), ("dZ", dZ)):
            got = np.concatenate([r[name] for r in ranks])
            np.testing.assert_allclose(got, np.asarray(w)[:n], rtol=3e-4, atol=1e-3,
                                       err_msg=f"N={n} {name}")


def test_train_vae_ranks_match_jax_mesh(pools):
    """(iii) train_vae on 2 ranks (13 × 7: 91 images, an odd split) against
    train_vae(mesh=make_mesh(2)), the JAX driver's init and draws injected."""
    over = VAE_CONFIG
    ds = jax_digits("synthetic", num_objects=VAE_GRID[0], num_views=VAE_GRID[1], seed=0)
    assert len(ds.images) % 2 == 1
    cfg = jtrain_vae.VAETrainConfig(**over)

    model = jtrain_vae._build_model(cfg, ds.image_shape)
    rng, init_key, sample_key = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    params = model.init(init_key, jnp.asarray(ds.images[:1]), sample_key)
    init = {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    position = np.empty(len(ds.images), np.int64)
    position[ds.train_idx] = np.arange(len(ds.train_idx))
    draws = []
    for e in range(cfg.epochs):
        key = epoch_keys(rng, e, 1)[0]
        rows, weights = jax_epoch_batches(key, jnp.asarray(ds.train_idx), cfg.batch_size)
        keys = jax.random.split(jax.random.fold_in(key, 1), rows.shape[0])
        eps = np.stack([jax.random.normal(k, (cfg.batch_size, cfg.zdim), jnp.float32)
                        for k in keys])
        eps_v = jax.random.normal(jax.random.fold_in(key, 2), (len(ds.val_idx), cfg.zdim),
                                  jnp.float32)
        draws.append([position[np.asarray(rows)], np.asarray(weights), eps, np.asarray(eps_v)])
    data = _data(VAE_GRID)
    ranks = pools(2).run(dryrun.train_vae_rank, data, over, init, draws)
    single = dryrun.train_vae(data, over, "cpu", init_params=init, draws=draws)
    for r in [*ranks, single]:
        for ours, theirs in zip(r["history"], _jax_vae_history()):
            for k in ("loss", "recon_term", "kl_term", "mse", "val_loss", "val_mse"):
                np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)
    assert len({r["digest"] for r in ranks}) == 1


def test_serving_ranks_match_single_device(pools):
    """(iv) the DP fold, predict_images (with variances) and observe on 2
    ranks against the JAX package's single-device serving calls on the same
    trained params (tests/test_parallel.py:169-222's setting)."""
    from gppvae_tpu.eval import build_server_state, predict_images
    from gppvae_tpu.eval.serving import observe

    ds = jax_digits("synthetic", num_objects=8, num_views=8, image_size=32, seed=0)
    cfg = jtrain.GPPVAETrainConfig(mode="joint", zdim=8, batch_size=16, obj_feature_dim=4,
                                   view_num_freqs=1, enc_features=(8, 16), dec_features=(16, 8))
    # the trainer's initial params: serving folds whatever params it is given
    model, jparams, fixed_W, *_ = jtrain._setup(ds, cfg, None, None)
    # float32, as the trainers keep them (X comes out float64 under x64)
    jparams = {**jparams, "gp": {k: jnp.asarray(v, jnp.float32) for k, v in jparams["gp"].items()}}
    tr = ds.train_idx[: trim_to_multiple(len(ds.train_idx), 8)]
    images_tr, d_tr, q_tr = ds.images[tr], ds.object_ids[tr], ds.view_ids[tr]
    ho = ds.heldout_idx[: trim_to_multiple(len(ds.heldout_idx), 8)]
    d_ho, q_ho, y_obs = ds.object_ids[ho], ds.view_ids[ho], ds.images[ho]
    state = build_server_state(model, jparams, fixed_W, jnp.asarray(images_tr),
                               jnp.asarray(d_tr), jnp.asarray(q_tr))
    y, var = predict_images(model, state, jnp.asarray(d_ho), jnp.asarray(q_ho),
                            return_var=True)
    state2 = observe(model, state, jnp.asarray(y_obs), jnp.asarray(d_ho), jnp.asarray(q_ho))
    y2 = predict_images(model, state2, jnp.asarray(d_ho), jnp.asarray(q_ho))

    params = {"vae": {k: v.numpy() for k, v in
                      flax_to_state_dict(jax.tree.map(np.asarray, jparams["vae"])).items()},
              "gp": {k: np.asarray(v) for k, v in jparams["gp"].items()}}
    model_kw = dict(zdim=8, image_shape=tuple(ds.image_shape), enc_features=(8, 16),
                    dec_features=(16, 8))
    ranks = pools(2).run(dryrun.serving_rank, model_kw, params, None, images_tr, d_tr, q_tr,
                         d_ho, q_ho, y_obs, 8)
    for r in ranks:
        for name, want in (("M", state.core.M), ("y", y), ("var", var), ("M2", state2.core.M),
                           ("y2", y2)):
            np.testing.assert_allclose(r[name], np.asarray(want), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    # what crosses the ranks: the fold's G with the row count and UᵀZ,
    # observe's U₊ᵀU₊ with U₊ᵀZ₊ (R = 4 · 3, L = 8), and the two replies
    # with the variances; nothing of the training rows' size
    R, L, n = 12, 8, len(ho)
    sent = [R * R + 1, R * L, y.size, n, R * R + R * L, y.size]
    for r in ranks:
        assert r["collectives"] == {"all_reduce": {
            "calls": len(sent), "bytes": 4 * sum(sent), "max_bytes": 4 * y.size}}


def test_collectives_do_not_grow_with_n(pools):
    """(v) the collectives of a training epoch (kind, calls, bytes) are the
    same at 53 and 56 training rows, and none is larger than the gradient
    all-reduce of both Adams' parameters: dryrun's checks, on 2 ranks."""
    out = dryrun.dryrun(2, device="cpu", pool=pools(2))
    assert out["n_train"] == [53, 56]
    assert 0 < out["max_bytes"] <= out["budget_bytes"]
    assert set(out["collectives"]) == {"all_reduce"}  # nothing is broadcast in an epoch


def test_check_replicated_catches_a_rank_that_differs(pools):
    """(vi) the per-epoch check raises on every rank when one rank's
    parameter differs in one bit."""
    errors = pools(2).run(dryrun.perturbed_check_rank)
    assert all("tensors [0] of 1 differ between the 2 ranks" in e for e in errors), errors
    assert pools(2).run(dryrun.perturbed_check_rank, False) == ["", ""]


def test_dp_state_resumes_in_one_process_and_back(pools, tmp_path):
    """final_state of a 2-rank run, resumed for a third epoch in one process,
    equals the 2-rank run resumed (rtol 1e-4); and a single-process state
    resumed on 2 ranks equals it resumed alone."""
    config = {**SMALL, "epochs": 2}
    data = _data((11, 8))
    pool = pools(2)
    pool.run(dryrun.train_gppvae_rank, data, config, None, None, str(tmp_path / "dp"))
    dryrun.train_gppvae(data, config, "cpu", outdir=str(tmp_path / "one"))
    more = {**config, "epochs": 3}
    for run in ("dp", "one"):
        state = str(tmp_path / run / "final_state")
        ranks = pool.run(dryrun.train_gppvae_rank, data, more, None, None, None, state)
        alone = dryrun.train_gppvae(data, more, "cpu", resume=state)
        assert [h["epoch"] for h in alone["history"]] == [2]
        for r in ranks:
            assert [h["epoch"] for h in r["history"]] == [2]
            for k in dryrun.KEYS:
                np.testing.assert_allclose(r["history"][0][k], alone["history"][0][k],
                                           rtol=1e-4, err_msg=f"{run}: {k}")
    assert (tmp_path / "dp" / "metrics.jsonl").is_file()
    assert (tmp_path / "dp" / "config.json").is_file()
