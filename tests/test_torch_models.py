"""The port's conv VAE (gppvae_tpu_torch.models) against the flax VAE.

Weights come from a flax init and are converted with gppvae_tpu_torch.convert;
inputs are numpy arrays from a seed. float32 throughout: outputs agree to
rtol 1e-4 / atol 2e-5 and parameter gradients to rtol 1e-3 / atol 1e-5 of
each gradient's largest entry (f32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from gppvae_tpu.models import VAE as FlaxVAE
from gppvae_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gppvae_tpu_torch.models import VAE, encode_all
from gppvae_tpu_torch.models.vae import _same_pad

WIDTHS = {
    "full": dict(zdim=16, enc=(32, 64, 128), dec=(128, 64, 32)),  # BASELINE joint
    "golden": dict(zdim=6, enc=(8, 16), dec=(16, 8)),  # tests/test_golden.py
}
SHAPE = (32, 32, 1)


def _pair(width, seed=0):
    w = WIDTHS[width]
    fm = FlaxVAE(zdim=w["zdim"], image_shape=SHAPE, enc_features=w["enc"],
                 dec_features=w["dec"])
    y0 = jnp.zeros((1, *SHAPE), jnp.float32)
    fp = fm.init(jax.random.PRNGKey(seed), y0, jax.random.PRNGKey(seed + 1))
    tm = VAE(w["zdim"], SHAPE, w["enc"], w["dec"])
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, fp)))
    return fm, fp, tm


def _inputs(zdim, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, *SHAPE)).astype(np.float32),
            rng.standard_normal((n, zdim)).astype(np.float32))


def test_full_width_param_count():
    fm, fp, tm = _pair("full")
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(fp))
    assert n_flax == sum(p.numel() for p in tm.parameters()) == 634_017


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_forward_matches_flax(width):
    fm, fp, tm = _pair(width)
    y, z = _inputs(WIDTHS[width]["zdim"])
    mu, logvar = fm.apply(fp, jnp.asarray(y), method=FlaxVAE.encode)
    logits = fm.apply(fp, jnp.asarray(z), method=FlaxVAE.decode)
    with torch.no_grad():
        tmu, tlogvar = tm.encode(torch.from_numpy(y))
        tlogits = tm.decode(torch.from_numpy(z))
    assert tlogits.shape == (5, *SHAPE)  # NHWC out
    for a, b in ((tmu, mu), (tlogvar, logvar), (tlogits, logits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=2e-5)
    Z = encode_all(tm, torch.from_numpy(np.concatenate([y, y[:2]])), chunk=3)
    np.testing.assert_allclose(Z[:5].numpy(), tmu.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_param_gradients_match_flax(width):
    fm, fp, tm = _pair(width, seed=4)
    zdim = WIDTHS[width]["zdim"]
    y, z = _inputs(zdim, seed=5)
    rng = np.random.default_rng(6)
    A, B = (rng.standard_normal((5, zdim)).astype(np.float32) for _ in range(2))
    C = rng.standard_normal((5, *SHAPE)).astype(np.float32)

    def jloss(p):
        mu, logvar = fm.apply(p, jnp.asarray(y), method=FlaxVAE.encode)
        logits = fm.apply(p, jnp.asarray(z), method=FlaxVAE.decode)
        return jnp.sum(mu * A) + jnp.sum(logvar * B) + jnp.sum(jnp.tanh(logits) * C)

    jg = jax.grad(jloss)(fp)
    mu, logvar = tm.encode(torch.from_numpy(y))
    logits = tm.decode(torch.from_numpy(z))
    loss = (torch.sum(mu * torch.from_numpy(A)) + torch.sum(logvar * torch.from_numpy(B))
            + torch.sum(torch.tanh(logits) * torch.from_numpy(C)))
    loss.backward()
    tg = state_dict_to_flax({k: p.grad for k, p in tm.named_parameters()})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5 * np.abs(b).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_stride2_same_padding_regression():
    """flax SAME at stride 2 pads (0, 1) on an even axis; Conv2d(padding=1)
    pads (1, 1) and gives another function."""
    assert _same_pad(32) == (0, 1) and _same_pad(8) == (0, 1) and _same_pad(7) == (1, 1)
    conv = nn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(np.float32)
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(p, jnp.asarray(x))).transpose(0, 3, 1, 2)
    w = torch.from_numpy(np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    b = torch.from_numpy(np.asarray(p["params"]["bias"]).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    explicit = F.conv2d(F.pad(xt, (0, 1, 0, 1)), w, b, stride=2)
    np.testing.assert_allclose(explicit.numpy(), want, rtol=1e-5, atol=1e-5)
    symmetric = F.conv2d(xt, w, b, stride=2, padding=1)
    assert np.abs(symmetric.numpy() - want).max() > 1e-2


def test_convert_round_trip():
    _, fp, tm = _pair("golden", seed=8)
    tree = jax.tree.map(np.asarray, fp)
    back = state_dict_to_flax(flax_to_state_dict(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert set(tm.state_dict()) == set(flax_to_state_dict(tree))
