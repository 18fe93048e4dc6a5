"""The port's serving path (gppvae_tpu_torch.eval.serving, .generate and the
GP algebra under them) against the JAX package on the same inputs.

One module-scoped JAX training at the size of tests/test_serving.py (10
objects × 8 views, 32², zdim 8, 2 epochs); its params go into the port
through convert, and no test trains JAX again. Tolerances:
  * the core algebra (extend_posterior_core, predict_cov_from_core, the
    dense oracle) in float64: rtol 1e-10;
  * served images and variances in float32, from one state carried over
    whole (convert.server_state_from_numpy) or built by each package from
    the same weights: rtol 1e-5, atol 1e-6; posterior cores built by each
    package: rtol 1e-4, atol 1e-5 (two encoders' f32 latents through an
    R×R solve). Under the suite's x64 mode the JAX trainer's GP params, and
    so its serving GP algebra, are float64; the port's are float32;
  * the generate CLI's sampling modes with the JAX draws injected, and the
    chained-observe drift bound of the JAX package's own test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gppvae_tpu import gp as jgp
from gppvae_tpu.data import build_rotated_digits
from gppvae_tpu.eval import generate as jgenerate
from gppvae_tpu.eval import serving as jserving
from gppvae_tpu.eval.oos import oos_predict_images as j_oos_predict_images
from gppvae_tpu.models import VAE as JVAE
from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae
from gppvae_tpu.utils.metrics import NullLogger
from gppvae_tpu_torch import gp
from gppvae_tpu_torch.convert import (
    flax_to_state_dict,
    gp_params_from_numpy,
    rff_draws_from_map,
    server_state_from_numpy,
)
from gppvae_tpu_torch.eval import generate, serving
from gppvae_tpu_torch.eval.oos import oos_predict_images, predict_heldout
from gppvae_tpu_torch.models import VAE, encode_all
from gppvae_tpu_torch.utils import prng
from _one_thread import one_thread  # noqa: F401

ARCH = dict(zdim=8, enc_features=(8, 16), dec_features=(16, 8), object_kernel="linear",
            rff_features=32, rff_lengthscale=1.0, extra_effects=(), seed=0,
            dec_upsample="resize", compute_dtype="float32")
F32 = dict(rtol=1e-5, atol=1e-6)
CORE_F32 = dict(rtol=1e-4, atol=1e-5)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.detach().cpu() if torch.is_tensor(a) else a),
                               np.asarray(b), **tol)


@pytest.fixture(scope="module")
def trained():
    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, image_size=32, seed=0)
    cfg = GPPVAETrainConfig(mode="joint", zdim=8, epochs=2, batch_size=32,
                            obj_feature_dim=4, view_num_freqs=1,
                            enc_features=(8, 16), dec_features=(16, 8))
    res = train_gppvae(ds, cfg, log=NullLogger())
    sd = flax_to_state_dict(jax.tree.map(np.asarray, res.params["vae"]))
    model = VAE(8, ds.image_shape, (8, 16), (16, 8))
    model.load_state_dict(sd)
    tr, ho = ds.train_idx, ds.heldout_idx

    def rows(idx):
        return {"y": ds.images[idx], "d": ds.object_ids[idx], "q": ds.view_ids[idx]}

    jstate = jserving.build_server_state(res.model, res.params, res.fixed_W,
                                         jnp.asarray(ds.images[tr]),
                                         jnp.asarray(ds.object_ids[tr]),
                                         jnp.asarray(ds.view_ids[tr]))
    return dict(ds=ds, jres=res, model=model,
                params={"vae": sd, "gp": gp_params_from_numpy(res.params["gp"])},
                tr=rows(tr), ho=rows(ho), jstate=jstate,
                state=server_state_from_numpy({**jstate._asdict(),
                                               "core": jstate.core._asdict()}))


def _t(rows):
    return (torch.from_numpy(rows["y"]), torch.as_tensor(rows["d"], dtype=torch.int64),
            torch.as_tensor(rows["q"], dtype=torch.int64))


def _j(rows):
    return jnp.asarray(rows["y"]), jnp.asarray(rows["d"]), jnp.asarray(rows["q"])


def _port_state(t):
    y, d, q = _t(t["tr"])
    return serving.build_server_state(t["model"], t["params"], None, y, d, q)


# -- the core algebra, float64 ------------------------------------------------

def test_extend_posterior_core_exact_f64():
    """Folding rows in two or three steps equals one factorization over all
    of them, and equals the JAX package's extend step (the port of
    tests/test_serving.py:186-223)."""
    rng = np.random.default_rng(7)
    n1, n2, r, L = 40, 13, 6, 5
    V, Z = rng.normal(size=(n1 + n2, r)), rng.normal(size=(n1 + n2, L))
    tV, tZ = torch.tensor(V), torch.tensor(Z)
    jV, jZ = jnp.asarray(V), jnp.asarray(Z)
    vs, vn = 0.7, 0.3

    core1 = gp.posterior_core(gp.factorize(tV[:n1], vs, vn), tZ[:n1])
    inc = gp.extend_posterior_core(core1, tV[n1:], vs, tZ[n1:])
    full = gp.posterior_core(gp.factorize(tV, vs, vn), tZ)
    jinc = jgp.extend_posterior_core(
        jgp.posterior_core(jgp.factorize(jV[:n1], jnp.float64(vs), jnp.float64(vn)), jZ[:n1]),
        jV[n1:], jnp.float64(vs), jZ[n1:])
    for name in ("M", "G", "Lb"):
        _close(getattr(inc, name), getattr(full, name), rtol=1e-10, atol=1e-12)
        _close(getattr(inc, name), getattr(jinc, name), rtol=1e-10, atol=1e-12)
    Vq = torch.tensor(rng.normal(size=(9, r)))
    for a, b in zip(gp.predict_from_core(Vq, inc, vs, return_var=True),
                    gp.predict_from_core(Vq, full, vs, return_var=True)):
        _close(a, b, rtol=1e-10)

    corea = gp.posterior_core(gp.factorize(tV[:20], vs, vn), tZ[:20])
    corec = gp.extend_posterior_core(gp.extend_posterior_core(corea, tV[20:n1], vs, tZ[20:n1]),
                                     tV[n1:], vs, tZ[n1:])
    _close(corec.M, full.M, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="rank"):
        gp.extend_posterior_core(core1, tV[n1:, : r - 1], vs, tZ[n1:])


def test_predict_cov_from_core_matches_jax_and_dense():
    """The joint covariance equals the JAX package's and the dense oracle's
    K(*,*) − K(*,·)K⁻¹K(·,*); its diagonal is predict_from_core's variance.
    The dense oracle also matches the Woodbury NLL and mean, and the JAX
    package's dense module."""
    rng = np.random.default_rng(3)
    N, n, r, L = 30, 7, 5, 4
    V, Vq, Z = rng.normal(size=(N, r)), rng.normal(size=(n, r)), rng.normal(size=(N, L))
    vs, vn = 0.8, 0.25
    tV, tVq, tZ = torch.tensor(V), torch.tensor(Vq), torch.tensor(Z)
    core = gp.posterior_core(gp.factorize(tV, vs, vn), tZ)
    mean, cov = gp.predict_cov_from_core(tVq, core, vs)
    jcore = jgp.posterior_core(jgp.factorize(jnp.asarray(V), jnp.float64(vs), jnp.float64(vn)),
                               jnp.asarray(Z))
    jmean, jcov = jgp.predict_cov_from_core(jnp.asarray(Vq), jcore, jnp.float64(vs))
    _close(mean, jmean, rtol=1e-10)
    _close(cov, jcov, rtol=1e-10, atol=1e-12)
    _, var = gp.predict_from_core(tVq, core, vs, return_var=True)
    _close(torch.diagonal(cov), var, rtol=1e-10)

    K = gp.dense.materialize_K(tV, vs, vn)
    Ks = vs * tVq @ tV.T
    Kss = vs * tVq @ tVq.T + vn * torch.eye(n, dtype=torch.float64)
    _close(gp.dense.dense_predict_cov(Ks, Kss, K), cov, rtol=1e-10, atol=1e-12)
    _close(gp.dense.dense_predict(Ks, K, tZ), mean, rtol=1e-10, atol=1e-12)
    nll = gp.gp_nll_from_features(tZ, tV, vs, vn)
    _close(gp.dense.dense_nll(tZ, K), nll, rtol=1e-10)
    from gppvae_tpu.gp import dense as jdense

    jK = jdense.materialize_K(jnp.asarray(V), jnp.float64(vs), jnp.float64(vn))
    _close(K, jK, rtol=1e-12)
    _close(gp.dense.dense_nll(tZ, K, include_const=False),
           jdense.dense_nll(jnp.asarray(Z), jK, include_const=False), rtol=1e-10)


def test_chained_observe_f32_drift_bounded():
    """500 chained float32 extend steps in the stressed regime (repeated
    cells, v_n = 0.01) stay within the JAX package's own bounds
    (tests/test_serving.py:226-273): drift from a one-shot f32 refold
    ≤ 2.5e-5, error against float64 ≤ 20× the refold's."""
    rng = np.random.default_rng(0)
    R, L, N0 = 48, 16, 200
    pool_V = rng.standard_normal((40, R))
    V0 = torch.tensor(rng.standard_normal((N0, R)), dtype=torch.float32)
    Z0 = torch.tensor(rng.standard_normal((N0, L)), dtype=torch.float32)
    vs, vn = torch.tensor(0.8), torch.tensor(0.01)
    core = gp.posterior_core(gp.factorize([V0], [vs], vn), Z0)
    Vs_all, Zs_all = [V0], [Z0]
    for _ in range(500):
        Vn = torch.tensor(pool_V[rng.integers(0, 40, 2)], dtype=torch.float32)
        Zn = torch.tensor(rng.standard_normal((2, L)), dtype=torch.float32)
        Vs_all.append(Vn)
        Zs_all.append(Zn)
        core = gp.extend_posterior_core(core, [Vn], [vs], Zn)
    Vall, Zall = torch.cat(Vs_all), torch.cat(Zs_all)
    core_fold = gp.posterior_core(gp.factorize([Vall], [vs], vn), Zall)
    core_64 = gp.posterior_core(gp.factorize([Vall.double()], [0.8], torch.tensor(0.01).double()),
                                Zall.double())
    Vq = torch.tensor(pool_V[:32])
    m_chain = gp.predict_from_core([Vq.float()], core, [vs]).double()
    m_fold = gp.predict_from_core([Vq.float()], core_fold, [vs]).double()
    m_64 = gp.predict_from_core([Vq], core_64, [0.8])
    drift = float((m_chain - m_fold).abs().max())
    fold_err = float((m_fold - m_64).abs().max())
    chain_err = float((m_chain - m_64).abs().max())
    assert drift <= 2.5e-6 * 10, drift
    assert chain_err <= 20 * max(fold_err, 1e-7), (chain_err, fold_err)


# -- the serving library against JAX --------------------------------------------

def test_build_server_state_and_predict_images_match_jax(trained):
    """Each package builds its state from the same weights and rows; the
    served means and variances agree, and equal the port's predict_heldout."""
    t = trained
    state = _port_state(t)
    jstate = t["jstate"]
    _close(state.core.G, jstate.core.G, rtol=1e-5, atol=1e-6)
    _close(state.core.M, jstate.core.M, **CORE_F32)
    _close(state.v_sig, jstate.v_sig, rtol=1e-6)
    _, d_ho, q_ho = _t(t["ho"])
    y, var = serving.predict_images(t["model"], state, d_ho, q_ho, return_var=True)
    jy, jvar = jserving.predict_images(t["jres"].model, jstate, *_j(t["ho"])[1:], return_var=True)
    assert y.shape == (len(d_ho), 32, 32, 1) and y.dtype == torch.float32
    _close(y, jy, **F32)
    _close(var, jvar, **F32)
    assert bool((var > 0).all())

    y_tr, d_tr, q_tr = _t(t["tr"])
    Z0 = encode_all(t["model"], y_tr, 1024)
    y_ref, _ = predict_heldout(t["model"], t["params"]["gp"], None, Z0, d_tr, q_tr,
                               d_ho, q_ho, torch.from_numpy(t["ho"]["y"]))
    _close(y, y_ref, rtol=1e-6, atol=1e-6)
    n = len(t["tr"]["d"])  # the state holds nothing N-sized
    for leaf in (*state.core, state.X, state.W, state.v_sig):
        assert n not in leaf.shape


def test_predict_images_on_the_jax_state(trained):
    """The JAX state carried over whole: means and variances at f32."""
    t = trained
    _, d, q = _t(t["ho"])
    y, var = serving.predict_images(t["model"], t["state"], d, q, return_var=True)
    jy, jvar = jserving.predict_images(t["jres"].model, t["jstate"], *_j(t["ho"])[1:],
                                       return_var=True)
    _close(y, jy, **F32)
    _close(var, jvar, **F32)
    assert torch.equal(serving.predict_images(t["model"], t["state"], d, q), y)


@pytest.mark.parametrize("joint", [False, True])
def test_sample_images_matches_jax(trained, joint):
    """K draws per row on the same state with the JAX draws injected, over a
    batch that requests one cell twice (the joint covariance is then near
    rank-deficient and goes through stable_cholesky's jitter)."""
    t = trained
    d = t["ho"]["d"][[0, 0, 1, 2]]
    q = t["ho"]["q"][[0, 0, 1, 2]]
    K, L = 5, 8
    key = jax.random.PRNGKey(3)  # drawn in the JAX state's dtype, as sample_images does
    eps = np.asarray(jax.random.normal(key, (len(d), K, L), t["jstate"].core.M.dtype))
    jy = jserving.sample_images(t["jres"].model, t["jstate"], jnp.asarray(d), jnp.asarray(q),
                                key, K, joint=joint)
    y = serving.sample_images(t["model"], t["state"], torch.as_tensor(d, dtype=torch.int64),
                              torch.as_tensor(q, dtype=torch.int64), None, K, joint=joint,
                              eps=eps)
    assert y.shape == (4, K, 32, 32, 1) and bool(torch.isfinite(y).all())
    _close(y, jy, **F32)


def test_joint_draws_keep_the_duplicate_cell_correlated(trained):
    """The port's own draws (from a key): deterministic, diverse,
    and for a cell requested twice the joint draws of the two rows differ
    less than independent draws (tests/test_serving.py:922-953)."""
    t = trained
    d = torch.as_tensor(t["ho"]["d"][[0, 0]], dtype=torch.int64)
    q = torch.as_tensor(t["ho"]["q"][[0, 0]], dtype=torch.int64)

    def draw(joint):
        return serving.sample_images(t["model"], t["state"], d, q,
                                     prng.PRNGKey(3), 48, joint=joint).numpy()

    yj, yi = draw(True), draw(False)
    np.testing.assert_array_equal(yj, draw(True))
    assert float(np.max(np.std(yj, axis=1))) > 1e-4
    msd_joint = float(np.mean(np.square(yj[0] - yj[1])))
    msd_indep = float(np.mean(np.square(yi[0] - yi[1])))
    assert msd_joint < 0.97 * msd_indep, (msd_joint, msd_indep)


@pytest.mark.parametrize("joint", [False, True])
def test_decode_chunked_matches_single_forward(trained, joint):
    """n·K = 63 rows decoded in chunks of 8 (a ragged tail) equal one
    forward, with the same draws."""
    t = trained
    d = torch.as_tensor(np.tile(t["ho"]["d"][:3], 3), dtype=torch.int64)
    q = torch.as_tensor(np.tile(t["ho"]["q"][:3], 3), dtype=torch.int64)
    eps = torch.randn((9, 7, 8), generator=torch.Generator().manual_seed(11))
    a = serving.sample_images(t["model"], t["state"], d, q, None, 7, joint=joint,
                              decode_chunk=8, eps=eps)
    b = serving.sample_images(t["model"], t["state"], d, q, None, 7, joint=joint,
                              decode_chunk=None, eps=eps)
    assert a.shape == (9, 7, 32, 32, 1)
    _close(a, b, atol=1e-6)


def test_observe_matches_jax_masked_rows_and_the_union_build(trained):
    """observe on the same state equals the JAX observe; weight-0 rows
    (row_mask) change nothing; and folding the held-out rows into a
    train-only state equals a build over train ∪ held-out."""
    t = trained
    y_ho, d_ho, q_ho = _t(t["ho"])
    jnew = jserving.observe(t["jres"].model, t["jstate"], *_j(t["ho"]))
    new = serving.observe(t["model"], t["state"], y_ho, d_ho, q_ho)
    _close(new.core.G, jnew.core.G, rtol=1e-5, atol=1e-6)
    _close(new.core.M, jnew.core.M, **CORE_F32)
    _close(new.core.Lb, jnew.core.Lb, rtol=1e-5, atol=1e-6)

    junk = torch.rand((3, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([1.0] * len(d_ho) + [0.0] * 3)
    masked = serving.observe(t["model"], t["state"], torch.cat([y_ho, junk]),
                             torch.cat([d_ho, d_ho[:3]]), torch.cat([q_ho, q_ho[:3]]),
                             row_mask=mask)
    for a, b in zip(masked.core, new.core):
        _close(a, b, rtol=1e-6, atol=1e-7)
    jmasked = jserving.observe(t["jres"].model, t["jstate"],
                               jnp.concatenate([_j(t["ho"])[0], jnp.asarray(junk.numpy())]),
                               jnp.asarray(np.r_[t["ho"]["d"], t["ho"]["d"][:3]]),
                               jnp.asarray(np.r_[t["ho"]["q"], t["ho"]["q"][:3]]),
                               row_mask=jnp.asarray(mask.numpy()))
    _close(masked.core.M, jmasked.core.M, **CORE_F32)

    y_tr, d_tr, q_tr = _t(t["tr"])
    union = serving.build_server_state(t["model"], t["params"], None, torch.cat([y_tr, y_ho]),
                                       torch.cat([d_tr, d_ho]), torch.cat([q_tr, q_ho]))
    inc = serving.observe(t["model"], _port_state(t), y_ho, d_ho, q_ho)
    _close(inc.core.G, union.core.G, rtol=1e-5, atol=1e-5)
    _close(inc.core.M, union.core.M, rtol=1e-4, atol=1e-5)
    _, v0 = serving.predict_images(t["model"], t["state"], d_ho, q_ho, return_var=True)
    _, v1 = serving.predict_images(t["model"], new, d_ho, q_ho, return_var=True)
    assert bool((v1 <= v0 + 1e-6).all()) and bool((v1 < v0 - 1e-6).any())


@pytest.mark.parametrize("fn", ["predict_images", "sample_images", "observe"])
def test_effect_count_mismatch_raises(trained, fn):
    t = trained
    y, d, q = _t(t["ho"])
    call = {
        "predict_images": lambda: serving.predict_images(t["model"], t["state"], d, q,
                                                         extra_effects=("object",)),
        "sample_images": lambda: serving.sample_images(t["model"], t["state"], d, q, None, 2,
                                                       extra_effects=("object",)),
        "observe": lambda: serving.observe(t["model"], t["state"], y, d, q,
                                           extra_effects=("object",)),
    }[fn]
    with pytest.raises(ValueError, match="builds 2 effect"):
        call()


def test_rbf_object_effect_artifact_carries_its_rff_draws(trained, tmp_path):
    """An rbf state with an extra object effect: the artifact carries Ω, b
    (the JAX package rebuilds them from the seed through threefry), so the
    state served after save → load gives the images of the state before
    saving, through the library and the serve CLI; both equal the JAX
    package's serving of the same weights with the same map. Without the
    draws the rbf artifact refuses to serve."""
    t = trained
    jfn, _ = jgp.make_rff_map(4, 8, 0.9, seed=5)
    draws = rff_draws_from_map(jfn)
    x_map = gp.make_x_map("rbf", draws, 0.9)
    log_vs = t["params"]["gp"]["log_vs"]
    params = {"vae": t["params"]["vae"],
              "gp": {**t["params"]["gp"], "log_vs": torch.cat([log_vs, log_vs - 0.5])}}
    y_tr, d_tr, q_tr = _t(t["tr"])
    _, d_ho, q_ho = _t(t["ho"])
    extra = ("object",)
    state = serving.build_server_state(t["model"], params, None, y_tr, d_tr, q_tr,
                                       x_map=x_map, extra_effects=extra)
    assert state.core.M.shape == (8 * 3 + 4, 8)
    before = serving.predict_images(t["model"], state, d_ho, q_ho, x_map=x_map,
                                    extra_effects=extra)

    jp = t["jres"].params
    jparams = {**jp, "gp": {**jp["gp"], "log_vs": jnp.asarray(params["gp"]["log_vs"].numpy())}}
    jstate = jserving.build_server_state(t["jres"].model, jparams, None, *_j(t["tr"]),
                                         x_map=jgp.make_x_map("rbf", 4, 8, 0.9, 5),
                                         extra_effects=extra)
    jy = jserving.predict_images(t["jres"].model, jstate, *_j(t["ho"])[1:],
                                 x_map=jgp.make_x_map("rbf", 4, 8, 0.9, 5), extra_effects=extra)
    _close(before, jy, **F32)

    meta = {**ARCH, "object_kernel": "rbf", "rff_features": 8, "rff_lengthscale": 0.9,
            "extra_effects": list(extra), "image_shape": [32, 32, 1]}
    path = str(tmp_path / "rbf.srv")
    serving.save_server_state(path, state, meta=meta, rff_draws=draws)
    loaded, got = serving.load_server_state(path)
    assert torch.equal(got["rff_draws"][0], draws[0]) and "nystrom_idx" not in got
    after = serving.predict_images(t["model"], loaded, d_ho, q_ho,
                                   x_map=serving.x_map_from_meta(got, loaded.X.shape[1]),
                                   extra_effects=tuple(got["extra_effects"]))
    assert torch.equal(before, after)

    pairs = ",".join(f"{a}:{b}" for a, b in zip(t["ho"]["d"], t["ho"]["q"]))
    serving.main(["--state", path, "--device", "cpu", "--requests", pairs,
                  "--outdir", str(tmp_path / "cli")])
    _close(np.load(tmp_path / "cli" / "served.npz")["images"], before, rtol=0, atol=1e-7)

    bare = str(tmp_path / "bare.srv")
    serving.save_server_state(bare, state, meta=meta)
    _, got = serving.load_server_state(bare)
    with pytest.raises(ValueError, match="RFF draws"):
        serving.x_map_from_meta(got, 4)


def test_oos_predict_images_matches_jax(trained):
    t = trained
    y_tr, d_tr, q_tr = _t(t["tr"])
    _, d_ho, q_ho = _t(t["ho"])
    p = t["params"]["gp"]
    v_sig, v_noise = gp.variances_from_log(p["log_vs"], p["log_vn"])
    factors = gp.factorize(gp.build_effect_rows(p["X"], p["W"], d_tr, q_tr), v_sig[0], v_noise)
    Z0 = encode_all(t["model"], y_tr, 1024)
    V_ho = gp.build_effect_rows(p["X"], p["W"], d_ho, q_ho)
    y = oos_predict_images(t["model"].decode, V_ho, factors, Z0, [v_sig[0]])
    jp = t["jres"].params
    jv, jn = jgp.variances_from_log(jp["gp"]["log_vs"], jp["gp"]["log_vn"])
    jf = jgp.factorize(jgp.build_effect_rows(jp["gp"]["X"], jp["gp"]["W"], *_j(t["tr"])[1:]),
                       jv[0], jn)
    jV_ho = jgp.build_effect_rows(jp["gp"]["X"], jp["gp"]["W"], *_j(t["ho"])[1:])
    jy = j_oos_predict_images(
        lambda z: t["jres"].model.apply(jp["vae"], z, method=JVAE.decode), jV_ho, jf,
        jnp.asarray(Z0.numpy()), [jv[0]])
    _close(y, jy, **F32)


# -- generate's modes against JAX, with the JAX draws injected --------------------

def _jax_state(t):
    return {"params": t["jres"].params}


def _port_run_state(t):
    return {"vae": t["params"]["vae"], "gp": t["params"]["gp"], "fixed_W": None,
            "object_kernel": None}


@pytest.mark.parametrize("mode", ["generate_heldout", "synthesize_views", "sample_prior",
                                  "sample_posterior", "sample_posterior_sweep"])
def test_generate_modes_match_jax(trained, mode):
    t, ds = trained, trained["ds"]
    js, ts = _jax_state(t), _port_run_state(t)
    if mode == "generate_heldout":
        jy, jmse = jgenerate.generate_heldout(js, ds, **ARCH)
        y, mse = generate.generate_heldout(ts, ds, **ARCH)
        assert mse == pytest.approx(jmse, rel=1e-5)
    elif mode == "synthesize_views":
        jy = jgenerate.synthesize_views(js, ds, 3, **ARCH)
        y = generate.synthesize_views(ts, ds, 3, **ARCH)
    elif mode == "sample_prior":
        n = 6
        kd, kq, kr, kn = jax.random.split(jax.random.PRNGKey(4), 4)
        draws = {"d": np.asarray(jax.random.randint(kd, (n,), 0, ds.num_objects)),
                 "q": np.asarray(jax.random.randint(kq, (n,), 0, ds.num_views)),
                 "eps_r": np.asarray(jax.random.normal(kr, (4 * 3, 8))),
                 "eps_n": np.asarray(jax.random.normal(kn, (n, 8)))}
        jy = jgenerate.sample_prior(js, ds, n, draw_seed=4, **ARCH)
        y = generate.sample_prior(ts, ds, n, draw_seed=4, draws=draws, **ARCH)
    elif mode == "sample_posterior":
        eps = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, 8)))
        jy, jvar = jgenerate.sample_posterior(js, ds, 2, 5, 5, **ARCH)
        y, var = generate.sample_posterior(ts, ds, 2, 5, 5, eps=eps, **ARCH)
        assert var == pytest.approx(jvar, rel=1e-5)
    else:
        eps = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (8, 4, 8),
                                           t["jstate"].core.M.dtype))
        jy, jvar = jgenerate.sample_posterior_sweep(js, ds, 2, 4, draw_seed=9, **ARCH)
        y, var = generate.sample_posterior_sweep(ts, ds, 2, 4, eps=eps, **ARCH)
        assert y.shape == (4, 8, 32, 32, 1)
        _close(var, jvar, **F32)
    assert y.shape == np.asarray(jy).shape and np.isfinite(y).all()
    _close(y, jy, **F32)


@pytest.mark.parametrize("mode", ["sample_prior", "sample_posterior", "sample_posterior_sweep",
                                  "serve_sample"])
def test_draws_match_jax_without_injection(trained, tmp_path, mode):
    """generate's sampling modes and one `serve --state --sample 3 --seed 5`
    reply with the port's own draws from the seed: the JAX package's stream
    (utils/prng.py: its randint cells and normal ε), so the images equal
    the JAX functions' at the same seed (its production stream: x64 off)."""
    t, ds = trained, trained["ds"]
    js, ts = _jax_state(t), _port_run_state(t)
    with jax.enable_x64(False):
        if mode == "sample_prior":
            jy = jgenerate.sample_prior(js, ds, 6, draw_seed=4, **ARCH)
            y = generate.sample_prior(ts, ds, 6, draw_seed=4, **ARCH)
        elif mode == "sample_posterior":
            jy, jvar = jgenerate.sample_posterior(js, ds, 2, 5, 5, **ARCH)
            y, var = generate.sample_posterior(ts, ds, 2, 5, 5, **ARCH)
        elif mode == "sample_posterior_sweep":
            jy, jvar = jgenerate.sample_posterior_sweep(js, ds, 2, 4, draw_seed=9, **ARCH)
            y, var = generate.sample_posterior_sweep(ts, ds, 2, 4, draw_seed=9, **ARCH)
        else:
            d, q = t["ho"]["d"][:4], t["ho"]["q"][:4]
            jy = jserving.sample_images(t["jres"].model, t["jstate"], jnp.asarray(d),
                                        jnp.asarray(q), jax.random.PRNGKey(5), 3)
            path = str(tmp_path / "m.srv")
            serving.save_server_state(path, t["state"], meta={**ARCH, "image_shape": [32, 32, 1]})
            serving.main(["--state", path, "--device", "cpu", "--sample", "3", "--seed", "5",
                          "--requests", ",".join(f"{a}:{b}" for a, b in zip(d, q)),
                          "--outdir", str(tmp_path / "cli")])
            y = np.load(tmp_path / "cli" / "served.npz")["images"]
    assert y.shape == np.asarray(jy).shape and np.isfinite(y).all()
    _close(y, jy, **F32)


def test_generate_draws_are_seeded(trained):
    """Without injected draws each mode draws from PRNGKey(draw_seed), else
    PRNGKey(seed): the same seed gives the same images, another draw_seed
    other ones."""
    t, ds = trained, trained["ds"]
    ts = _port_run_state(t)
    a = generate.sample_prior(ts, ds, 4, **ARCH)
    np.testing.assert_array_equal(a, generate.sample_prior(ts, ds, 4, **ARCH))
    assert not np.array_equal(a, generate.sample_prior(ts, ds, 4, draw_seed=1, **ARCH))
    b, _ = generate.sample_posterior_sweep(ts, ds, 1, 3, draw_seed=2, **ARCH)
    np.testing.assert_array_equal(b, generate.sample_posterior_sweep(ts, ds, 1, 3, draw_seed=2,
                                                                     **ARCH)[0])


# -- the exported program against the JAX package's exported program -----------

EXE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def exported(trained, tmp_path_factory):
    """Both packages' compiled-program artifacts of the same state, all eight
    entries each: the JAX package's for the CPU, the port's from the JAX
    state carried over. Programs are loaded once and kept."""
    root = tmp_path_factory.mktemp("exe")
    t = trained
    jmeta = jserving.export_compiled_program(t["jres"].model, t["jstate"], str(root / "j.exe"),
                                             platforms=("cpu",))
    meta = serving.export_compiled_program(t["model"], t["state"], str(root / "t.exe"))
    programs = {}

    def program(which, entry):
        if (which, entry) not in programs:
            load = jserving.load_compiled_program if which == "jax" \
                else serving.load_compiled_program
            programs[which, entry] = load(str(root / f"{which[0]}.exe"), entry=entry)[0]
        return programs[which, entry]

    return dict(root=root, jmeta=jmeta, meta=meta, program=program)


def test_export_writes_the_jax_packages_entries(trained, exported):
    """The same eight names and file suffixes, the core sidecar and a meta
    with the grid, the image shape and each entry's file, sig and bytes; an
    unknown entry name raises as in the JAX function."""
    meta, jmeta, root = exported["meta"], exported["jmeta"], exported["root"]
    assert serving._EXE_ENTRIES.keys() == jserving._EXE_ENTRIES.keys()
    for name, e in serving._EXE_ENTRIES.items():
        assert e["suffix"] == jserving._EXE_ENTRIES[name]["suffix"]
        entry = meta["entry_points"][name]
        assert entry["file"] == "t.exe" + e["suffix"] == entry["files"]["cpu"]
        assert entry["sig"] == e["sig"] and "i64" in serving._EXE_ENTRIES["mean"]["sig"]
        assert entry["bytes"] == (root / entry["file"]).stat().st_size > 0
        if name.startswith("sample"):
            assert "eps:f32[b,k,L]" in e["sig"] and "seed" not in e["sig"]
    assert meta["format"] == "torch.export.v1" and jmeta["format"] == "jax.export.v2"
    assert meta["grid"] == jmeta["grid"] == [10, 8]
    assert meta["image_shape"] == jmeta["image_shape"] == [32, 32, 1]
    assert meta["zdim"] == 8 and meta["platforms"] == ["cpu"]
    assert meta["compute_dtype"] == "float32" and meta["torch"] == torch.__version__
    assert meta["core_npz"] == "t.exe.core.npz" and (root / "t.exe.core.npz").is_file()
    assert json.loads((root / "t.exe.meta.json").read_text()) == meta
    # only the half an entry runs is baked in: observe the encoder, the rest the decoder
    assert meta["total_bytes"] == sum(e["bytes"] for e in meta["entry_points"].values())
    with pytest.raises(ValueError, match="unknown export entry points: \\['median'\\]"):
        serving.export_compiled_program(trained["model"], trained["state"], str(root / "x.exe"),
                                        entry_points=("mean", "median"))
    partial = serving.export_compiled_program(trained["model"], trained["state"],
                                              str(root / "p.exe"), entry_points=("mean", "var"))
    assert partial["core_npz"] is None and not (root / "p.exe.core.npz").exists()
    with pytest.raises(ValueError, match="without the stateful entries"):
        serving.load_compiled_program(str(root / "p.exe"), "core")
    with pytest.raises(ValueError, match="no entry 'observe'"):
        serving.load_compiled_program(str(root / "p.exe"), "observe")


def _exe_request(t, b):
    d = t["ho"]["d"][[0, 0, 1, 2, 3][:b]]  # b = 5 asks for one cell twice
    q = t["ho"]["q"][[0, 0, 1, 2, 3][:b]]
    return d, q


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("entry", ["mean", "var", "predict_core"])
def test_exported_means_and_variances_match_jax(trained, exported, entry, b):
    """One artifact at b = 1 and b = 5: the port's program against the JAX
    package's program, and against the port's eager predict_images (the
    graph is the eager path's ops: within 1e-6, a batch of one may reach
    another BLAS routine)."""
    t = trained
    d, q = _exe_request(t, b)
    td, tq = torch.as_tensor(d, dtype=torch.int64), torch.as_tensor(q, dtype=torch.int64)
    core = serving.load_compiled_program(str(exported["root"] / "t.exe"), "core")[0]
    jcore = jserving.load_compiled_program(str(exported["root"] / "j.exe"), "core")[0]
    lead, jlead = ((tuple(core),), (jcore,)) if entry == "predict_core" else (((),), ())
    got = exported["program"]("torch", entry)(*lead[0], td, tq)
    want = exported["program"]("jax", entry).call(*jlead, jnp.asarray(d), jnp.asarray(q))
    eager = serving.predict_images(t["model"], t["state"], td, tq, return_var=entry != "mean")
    if entry == "mean":
        got, want, eager = (got,), (want,), (eager,)
    assert got[0].shape == (b, 32, 32, 1) and got[0].dtype == torch.float32
    for g, w, e in zip(got, want, eager):
        _close(g, w, **EXE_TOL)
        _close(g, e, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("entry", ["sample", "sample_joint", "sample_core", "sample_joint_core"])
def test_exported_draws_match_jax(trained, exported, entry, b, k):
    """The sample entries with the ε that the JAX entry draws from its seed
    argument, jax.random.normal(PRNGKey(seed), (b, K, L)), injected; b and k
    of 1 and more from the one artifact."""
    t = trained
    d, q = _exe_request(t, b)
    seed = 5
    # drawn in the JAX state's dtype, as its sample_images does inside the program
    eps = np.array(jax.random.normal(jax.random.PRNGKey(seed), (b, k, 8),
                                     t["jstate"].core.M.dtype), np.float32)
    jargs = (jnp.asarray(d), jnp.asarray(q), jnp.int32(seed), jnp.zeros((k,), jnp.int32))
    targs = (torch.as_tensor(d, dtype=torch.int64), torch.as_tensor(q, dtype=torch.int64),
             torch.from_numpy(eps))
    if entry.endswith("core"):
        jargs = (jserving.load_compiled_program(str(exported["root"] / "j.exe"), "core")[0],
                 *jargs)
        targs = (*serving.load_compiled_program(str(exported["root"] / "t.exe"), "core")[0],
                 *targs)
    got = exported["program"]("torch", entry)(*targs)
    want = exported["program"]("jax", entry).call(*jargs)
    assert got.shape == (b, k, 32, 32, 1)
    _close(got, want, **EXE_TOL)
    eager = serving.sample_images(t["model"], t["state"], targs[-3], targs[-2], None, k,
                                  joint="joint" in entry, eps=targs[-1], decode_chunk=None)
    _close(got, eager, rtol=0, atol=1e-6)


@pytest.mark.parametrize("b", [1, 5])
def test_exported_observe_matches_jax_with_masked_rows(trained, exported, b):
    """core' = observe(core, images, d, q, mask): b real rows and three
    weight-0 rows of noise against the JAX entry; the masked rows change
    nothing; predict_core on the new core answers as the JAX one does."""
    t = trained
    y, d, q = t["ho"]["y"][:b], t["ho"]["d"][:b], t["ho"]["q"][:b]
    junk = np.random.default_rng(0).random((3, 32, 32, 1), np.float32)
    images = np.concatenate([y, junk])
    dd, qq = np.r_[d, d[:1], d[:1], d[:1]], np.r_[q, q[:1], q[:1], q[:1]]
    mask = np.r_[np.ones(b, np.float32), np.zeros(3, np.float32)]
    core = serving.load_compiled_program(str(exported["root"] / "t.exe"), "core")[0]
    jcore = jserving.load_compiled_program(str(exported["root"] / "j.exe"), "core")[0]
    new = exported["program"]("torch", "observe")(
        *core, torch.from_numpy(images), torch.as_tensor(dd, dtype=torch.int64),
        torch.as_tensor(qq, dtype=torch.int64), torch.from_numpy(mask))
    jnew = exported["program"]("jax", "observe").call(
        jcore, jnp.asarray(images), jnp.asarray(dd), jnp.asarray(qq), jnp.asarray(mask))
    for g, w in zip(new, jnew):
        _close(g, w, **EXE_TOL)
    unmasked = exported["program"]("torch", "observe")(
        *core, torch.from_numpy(y), torch.as_tensor(d, dtype=torch.int64),
        torch.as_tensor(q, dtype=torch.int64), torch.ones(b))
    for g, w in zip(new, unmasked):
        _close(g, w, rtol=1e-6, atol=1e-7)
    td, tq = torch.as_tensor(d, dtype=torch.int64), torch.as_tensor(q, dtype=torch.int64)
    py, pvar = exported["program"]("torch", "predict_core")(*new, td, tq)
    jy, jvar = exported["program"]("jax", "predict_core").call(jnew, jnp.asarray(d),
                                                               jnp.asarray(q))
    _close(py, jy, **EXE_TOL)
    _close(pvar, jvar, **EXE_TOL)
    _, v0 = exported["program"]("torch", "var")(td, tq)
    assert bool((pvar < v0).all())  # the observed cells' variance fell
