"""The port's GP layer (gppvae_tpu_torch.gp) against gppvae_tpu.gp, in float64.

The same numpy arrays (from a seed) go through both packages; float64 on the
CPU, so the tolerances are tight: rtol 1e-10 unless a line says otherwise.
The exact epoch-gradient identity of tests/test_gp_math.py is ported as is.
The RBF (random Fourier feature) and Nyström object kernels and the extra
effects run in float32, as the trainers run them, with the JAX package's own
RFF draws carried over (convert.rff_draws_from_map): 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gppvae_tpu import gp as jgp
from gppvae_tpu_torch import gp
from gppvae_tpu_torch.convert import rff_draws_from_map
from _one_thread import one_thread  # noqa: F401

RTOL = 1e-10


def _problem(seed=0, N=96, L=7, P=11, Q=5, M=3, Mw=4):
    rng = np.random.default_rng(seed)
    return {
        "X": rng.standard_normal((P, M)), "W": rng.standard_normal((Q, Mw)),
        "d": rng.integers(0, P, N), "q": rng.integers(0, Q, N),
        "Z": rng.standard_normal((N, L)), "v_sig": 0.7, "v_noise": 0.3,
    }


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.as_tensor(v, dtype=torch.int64 if k in "dq" else torch.float64)
            for k, v in p.items()}


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), rtol=rtol, atol=atol)


def test_features_match():
    p = _problem(1)
    j, t = _j(p), _t(p)
    for normalize_W in (False, True):
        _close(gp.build_V(t["X"], t["W"], t["d"], t["q"], normalize_W=normalize_W),
               jgp.build_V(j["X"], j["W"], j["d"], j["q"], normalize_W=normalize_W))
    angles = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    _close(gp.fourier_view_features(torch.tensor(angles), num_freqs=3),
           jgp.fourier_view_features(jnp.asarray(angles), num_freqs=3))
    pos = np.linspace(-3.0, 5.0, 9)
    _close(gp.polynomial_view_features(torch.tensor(pos), degree=3),
           jgp.polynomial_view_features(jnp.asarray(pos), degree=3))
    (V,) = gp.build_effect_rows(t["X"], t["W"], t["d"], t["q"])
    (jV,) = jgp.build_effect_rows(j["X"], j["W"], j["d"], j["q"])
    _close(V, jV)


def test_unported_feature_options_raise():
    """Every feature option of the JAX package is ported; an unknown extra
    effect or object kernel raises ValueError, as there (features.py:190-200,
    :240-243)."""
    t = _t(_problem(2))
    with pytest.raises(ValueError, match="unknown extra effect 'pose'"):
        gp.build_effect_rows(t["X"], t["W"], t["d"], t["q"], extra_effects=("object", "pose"))
    with pytest.raises(ValueError, match="unknown object_kernel 'matern'"):
        gp.make_x_map("matern", gp.rff_draws(3, 8))
    with pytest.raises(ValueError, match="landmark"):
        gp.make_x_map("rbf-nystrom", gp.rff_draws(3, 8))
    with pytest.raises(ValueError, match="RFF draws"):
        gp.make_x_map("rbf")
    assert gp.make_x_map("linear") is None


def _f32(p):
    j = {k: jnp.asarray(v, jnp.float32 if k not in "dq" else jnp.int32) for k, v in p.items()}
    t = {k: torch.as_tensor(v, dtype=torch.int64 if k in "dq" else torch.float32)
         for k, v in p.items()}
    return j, t


def _close32(a, b):
    _close(a, b, rtol=1e-6, atol=1e-6)


def test_rff_and_nystrom_features_match():
    """RFF map, landmark indices and Nyström features against the JAX
    functions, in float32 with the JAX draws injected."""
    p = _problem(3, N=120, P=30, M=4, Mw=5)
    j, t = _f32(p)
    jfn, m = jgp.make_rff_map(4, 24, lengthscale=0.7, seed=5)
    draws = rff_draws_from_map(jfn)
    fn, m2 = gp.make_rff_map(draws, lengthscale=0.7)
    assert m == m2 == 24 and draws[0].shape == (4, 24) and draws[1].shape == (24,)
    jF = jfn(jgp.normalize_rows(j["X"]))
    F = fn(gp.normalize_rows(t["X"]))
    _close32(F, jF)
    own = gp.rff_draws(4, 24, seed=5)  # the port's own draws: fixed by the seed
    assert all(torch.equal(a, b) for a, b in zip(own, gp.rff_draws(4, 24, seed=5)))
    assert 0 <= float(own[1].min()) and float(own[1].max()) < 2 * np.pi

    jidx = jgp.pivoted_cholesky_landmarks(np.asarray(jF), 12)
    idx = gp.pivoted_cholesky_landmarks(F.numpy(), 12)
    np.testing.assert_array_equal(idx, jidx)
    assert idx.dtype == np.int32 and len(idx) == 12
    _close32(gp.nystrom_features(F, idx), jgp.nystrom.nystrom_features(jF, jidx))
    # rank found early: fewer landmarks than asked, as in the JAX function
    low = np.repeat(np.asarray(jF)[:3], 4, axis=0)
    np.testing.assert_array_equal(gp.pivoted_cholesky_landmarks(low, 8),
                                  jgp.pivoted_cholesky_landmarks(low, 8))

    for kind, nidx in (("rbf", None), ("rbf-nystrom", idx)):
        jmap = jgp.make_x_map(kind, 4, 24, 0.7, 5, None if nidx is None else jnp.asarray(nidx))
        tmap = gp.make_x_map(kind, draws, 0.7, nidx)
        _close32(gp.build_V(t["X"], t["W"], t["d"], t["q"], x_map=tmap),
                 jgp.build_V(j["X"], j["W"], j["d"], j["q"], x_map=jmap))


def test_extra_effect_rows_match():
    """build_effect_rows with the 'object' and 'view' effects (and an RBF
    object map on the product effect), float32."""
    p = _problem(4, N=90)
    j, t = _f32(p)
    jfn, _ = jgp.make_rff_map(3, 16, seed=1)
    tfn, _ = gp.make_rff_map(rff_draws_from_map(jfn))
    for x_maps in ((None, None), (jfn, tfn)):
        for extra in (("object",), ("view",), ("object", "view")):
            got = gp.build_effect_rows(t["X"], t["W"], t["d"], t["q"], extra_effects=extra,
                                       x_map=x_maps[1])
            want = jgp.build_effect_rows(j["X"], j["W"], j["d"], j["q"], extra_effects=extra,
                                         x_map=x_maps[0])
            assert len(got) == len(want) == 1 + len(extra)
            for a, b in zip(got, want):
                assert a.shape == b.shape
                _close32(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_nll_from_features_matches(seed):
    p = _problem(seed)
    j, t = _j(p), _t(p)
    jV = jgp.build_V(j["X"], j["W"], j["d"], j["q"])
    V = gp.build_V(t["X"], t["W"], t["d"], t["q"])
    for include_const in (True, False):
        _close(gp.gp_nll_from_features(t["Z"], V, t["v_sig"], t["v_noise"],
                                       include_const=include_const),
               jgp.gp_nll_from_features(j["Z"], jV, j["v_sig"], j["v_noise"],
                                        include_const=include_const))


def test_factorize_and_predict_latents_match():
    p = _problem(7)
    j, t = _j(p), _t(p)
    V = gp.build_V(t["X"], t["W"], t["d"], t["q"])
    jV = jgp.build_V(j["X"], j["W"], j["d"], j["q"])
    d_s, q_s = np.array([0, 3, 7]), np.array([1, 4, 2])
    V_s = gp.build_V(t["X"], t["W"], torch.tensor(d_s), torch.tensor(q_s))
    jV_s = jgp.build_V(j["X"], j["W"], jnp.asarray(d_s), jnp.asarray(q_s))
    f = gp.factorize(V, t["v_sig"], t["v_noise"])
    jf = jgp.factorize(jV, j["v_sig"], j["v_noise"])
    _close(f.logdet, jf.logdet)
    _close(f.Lb, jf.Lb, atol=1e-12)
    _close(gp.kinv_z_core(f, t["Z"]), jgp.kinv_z_core(jf, j["Z"]), atol=1e-12)
    mean, var = gp.predict_latents(V_s, f, t["Z"], t["v_sig"], return_var=True)
    jmean, jvar = jgp.predict_latents(jV_s, jf, j["Z"], j["v_sig"], return_var=True)
    _close(mean, jmean, atol=1e-12)
    _close(var, jvar)
    core = gp.posterior_core(f, t["Z"])
    _close(gp.predict_from_core(V_s, core, t["v_sig"]), jmean, atol=1e-12)


def test_variances_from_log_keeps_the_floor():
    v_sig, v_noise = gp.variances_from_log(torch.tensor([0.0]), torch.tensor(-50.0,
                                                                             dtype=torch.float64))
    assert gp.MIN_V_NOISE == jgp.woodbury.MIN_V_NOISE
    _close(v_noise, np.exp(-50.0) + gp.MIN_V_NOISE)
    _close(v_sig, [1.0])


def _taylor_setup(seed, N=80, L=6):
    p = _problem(seed, N=N, L=L)
    j, t = _j(p), _t(p)
    jV = jgp.build_V(j["X"], j["W"], j["d"], j["q"], normalize_X=True, normalize_W=True)
    V = gp.build_V(t["X"], t["W"], t["d"], t["q"], normalize_X=True, normalize_W=True)
    jaux = {"log_vs": jnp.log(j["v_sig"])[None], "log_vn": jnp.log(j["v_noise"])}
    aux = {"log_vs": torch.log(t["v_sig"])[None], "log_vn": torch.log(t["v_noise"])}

    def jnll(Z, V, aux):
        return jgp.gp_nll_from_features(Z, V, jnp.exp(aux["log_vs"][0]), jnp.exp(aux["log_vn"]))

    def nll(Z, V, aux):
        return gp.gp_nll_from_features(Z, V, torch.exp(aux["log_vs"][0]), torch.exp(aux["log_vn"]))

    return (jnll, j["Z"], jV, jaux), (nll, t["Z"], V, aux)


def test_taylor_expand_matches():
    (jnll, jZ, jV, jaux), (nll, Z, V, aux) = _taylor_setup(9)
    jc = jgp.taylor_expand(jnll, jZ, jV, jaux)
    c = gp.taylor_expand(nll, Z, V, aux)
    _close(c.value, jc.value)
    _close(c.dZ, jc.dZ, atol=1e-12)
    _close(c.dV, jc.dV, atol=1e-12)
    for k in ("log_vs", "log_vn"):
        _close(c.daux[k], jc.daux[k])
    assert not c.dZ.requires_grad and not Z.requires_grad  # fresh leaves, constants out


def test_surrogate_batch_term_matches():
    (jnll, jZ, jV, jaux), (nll, Z, V, aux) = _taylor_setup(10)
    jc = jgp.taylor_expand(jnll, jZ, jV, jaux)
    c = gp.taylor_expand(nll, Z, V, aux)
    idx = np.array([3, 17, 5, 60, 61, 0, 79, 3])
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)  # f32 weights promote to f64
    rng = np.random.default_rng(11)
    zb, vb = rng.standard_normal((8, Z.shape[1])), rng.standard_normal((8, V.shape[1]))
    for weights in (None, w):
        got = gp.surrogate_batch_term(
            c, torch.tensor(idx), torch.tensor(zb), torch.tensor(vb), aux, 80,
            weights=None if weights is None else torch.tensor(weights))
        want = jgp.surrogate_batch_term(
            jc, jnp.asarray(idx), jnp.asarray(zb), jnp.asarray(vb), jaux, 80,
            weights=None if weights is None else jnp.asarray(weights))
        assert got.dtype == torch.float64
        _close(got, want)


def _grads(fn, Z, V, aux):
    leaves = [Z.clone().requires_grad_(), V.clone().requires_grad_(),
              {k: v.clone().requires_grad_() for k, v in aux.items()}]
    out = fn(*leaves)
    flat = [leaves[0], leaves[1], leaves[2]["log_vn"], leaves[2]["log_vs"]]
    return torch.autograd.grad(out, flat)


@pytest.mark.parametrize("bs,weighted", [(16, False), (13, True)])
def test_surrogate_epoch_gradient_equals_full_gradient(bs, weighted):
    """Summing the per-batch surrogate gradients over one epoch reproduces
    the exact full-dataset NLL gradient at the expansion point, also when
    bs does not divide N (masked wrap-around plan); tests/test_gp_math.py's
    identity, ported."""
    from gppvae_tpu_torch.train.batching import epoch_batches
    from gppvae_tpu_torch.utils import prng

    _, (nll, Z0, V0, aux0) = _taylor_setup(12 if not weighted else 13)
    coeffs = gp.taylor_expand(nll, Z0, V0, aux0)
    N = Z0.shape[0]
    if weighted:
        batches, weights = epoch_batches(prng.PRNGKey(14), N, bs)
        assert batches.shape == (7, bs)
        flat = batches.reshape(-1)[weights.reshape(-1) > 0]
        assert sorted(flat.tolist()) == list(range(N))
    else:
        batches = torch.arange(N).reshape(-1, bs)
        weights = None

    def epoch_surrogate(Z, V, aux):
        total = 0.0
        for b in range(batches.shape[0]):
            idx = batches[b]
            total = total + gp.surrogate_batch_term(
                coeffs, idx, Z[idx], V[idx], aux, N,
                weights=None if weights is None else weights[b])
        return total

    for a, b in zip(_grads(epoch_surrogate, Z0, V0, aux0), _grads(nll, Z0, V0, aux0)):
        _close(a, b.numpy())
