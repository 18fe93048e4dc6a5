"""The port's conv VAE (gppvae_tpu_torch.models) against the flax VAE.

Weights come from a flax init and are converted with gppvae_tpu_torch.convert;
inputs are numpy arrays from a seed. float32: outputs agree to rtol 1e-4 /
atol 2e-5 and parameter gradients to rtol 1e-3 / atol 1e-5 of each
gradient's largest entry (f32 convolutions summed in another order). The
subpixel decoder agrees with flax's and with the port's resize decoder to
1e-5 of max |·| (forward and parameter gradients), as tests/test_subpixel.py
holds the JAX pair. bfloat16 compute: see test_bf16_vae_matches_flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from gppvae_tpu.models import VAE as FlaxVAE
from gppvae_tpu.models.vae import ConvDecoder as FlaxDecoder
from gppvae_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gppvae_tpu_torch.models import VAE, ConvDecoder, encode_all
from gppvae_tpu_torch.models.vae import _same_pad
from _one_thread import one_thread  # noqa: F401

WIDTHS = {
    "full": dict(zdim=16, enc=(32, 64, 128), dec=(128, 64, 32)),  # BASELINE joint
    "golden": dict(zdim=6, enc=(8, 16), dec=(16, 8)),  # tests/test_golden.py
}
SHAPE = (32, 32, 1)
# tests/test_subpixel.py's decoder shapes: (image_shape, features, zdim)
SUBPIXEL_CASES = [
    ((32, 32, 1), (128, 64, 32), 16),
    ((64, 64, 3), (64, 32, 16, 8), 8),
    ((16, 16, 2), (32, 16), 4),
]
BF16_REL_BOUND = 2e-2  # bfloat16 VAE vs flax's, max abs err / max |flax|


def _pair(width, seed=0, shape=SHAPE, dtype="float32", upsample="resize"):
    w = WIDTHS[width]
    fm = FlaxVAE(zdim=w["zdim"], image_shape=shape, enc_features=w["enc"],
                 dec_features=w["dec"], dtype=getattr(jnp, dtype), upsample=upsample)
    y0 = jnp.zeros((1, *shape), jnp.float32)
    fp = fm.init(jax.random.PRNGKey(seed), y0, jax.random.PRNGKey(seed + 1))
    tm = VAE(w["zdim"], shape, w["enc"], w["dec"], upsample, dtype=getattr(torch, dtype))
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, fp)))
    return fm, fp, tm


def _inputs(zdim, n=5, seed=3, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, *shape)).astype(np.float32),
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


def _decoders(image_shape, features, zdim, upsample):
    """A flax decoder and the port's, from the same flax init."""
    fd = FlaxDecoder(image_shape, features, upsample=upsample)
    fp = fd.init(jax.random.PRNGKey(0), jnp.zeros((1, zdim), jnp.float32))
    sd = flax_to_state_dict({"encoder": {}, "decoder": jax.tree.map(np.asarray, fp["params"])})
    td = ConvDecoder(zdim, image_shape, features, upsample)
    td.load_state_dict({k.removeprefix("decoder."): v for k, v in sd.items()})
    return fd, fp, td


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


@pytest.mark.parametrize("image_shape,features,zdim", SUBPIXEL_CASES)
def test_subpixel_decoder_matches_flax_and_resize(image_shape, features, zdim):
    """upsample='subpixel' (the port runs the resize forward for it) against
    flax's subpixel decoder (its tap-merged 'dilated' lowering) and the
    port's own resize decoder, forward and parameter gradients, ≤ 1e-5 of
    max |·|; the state_dicts are the same (checkpoints interchange)."""
    fd, fp, td = _decoders(image_shape, features, zdim, "subpixel")
    tr = ConvDecoder(zdim, image_shape, features, "resize")
    tr.load_state_dict(td.state_dict())
    z = np.random.default_rng(1).standard_normal((3, zdim)).astype(np.float32)
    C = np.random.default_rng(2).standard_normal((3, *image_shape)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jnp.tanh(fd.apply(p, jnp.asarray(z))) * C)

    want = fd.apply(fp, jnp.asarray(z))
    jg = flax_to_state_dict({"encoder": {}, "decoder": jax.tree.map(
        np.asarray, jax.grad(jloss)(fp)["params"])})
    outs, grads = [], []
    for dec in (td, tr):
        y = dec(torch.from_numpy(z))
        torch.sum(torch.tanh(y) * torch.from_numpy(C)).backward()
        outs.append(y.detach())
        grads.append({k: p.grad for k, p in dec.named_parameters()})
    assert outs[0].shape == (3, *image_shape)
    assert _rel(outs[0], want) <= 1e-5 and _rel(outs[0], outs[1]) <= 1e-5
    for k, g in grads[0].items():
        assert _rel(g, jg[f"decoder.{k}"]) <= 1e-5, k
        assert _rel(g, grads[1][k]) <= 1e-5, k


@pytest.mark.parametrize("upsample", ["resize", "subpixel"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_bf16_vae_matches_flax(width, upsample):
    """flax's dtype=bfloat16 semantics: params f32, each conv and dense
    casts its input and weights to bf16, μ, log σ² and logits come back f32.
    The two frameworks round bf16 at other places (torch adds the bias
    before rounding the conv's sum, XLA after), so they agree to a bound,
    not bit for bit: max abs err / max |flax| ≤ 2e-2. Measured on the CPU:
    ≤ 3.7e-3 at 32² (both widths) and ≤ 3.8e-3 at the face-view 128²×3
    width with the resize decoder; the port's subpixel decoder (the resize
    forward) against flax's tap-merged one, which rounds the merged kernel
    to bf16, ≤ 6.9e-3 and ≤ 5.7e-3."""
    fm, fp, tm = _pair(width, seed=2, dtype="bfloat16", upsample=upsample)
    zdim = WIDTHS[width]["zdim"]
    y, z = _inputs(zdim, seed=9)
    mu, logvar = fm.apply(fp, jnp.asarray(y), method=FlaxVAE.encode)
    logits = fm.apply(fp, jnp.asarray(z), method=FlaxVAE.decode)
    with torch.no_grad():
        tmu, tlogvar = tm.encode(torch.from_numpy(y))
        tlogits = tm.decode(torch.from_numpy(z))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    for a, b in ((tmu, mu), (tlogvar, logvar), (tlogits, logits)):
        assert a.dtype == torch.float32 and np.asarray(b).dtype == np.float32
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= BF16_REL_BOUND
    tm.dtype = torch.float32  # the polish switch: same params, f32 compute
    with torch.no_grad():
        assert _rel(tm.encode(torch.from_numpy(y))[0], tmu) <= BF16_REL_BOUND
