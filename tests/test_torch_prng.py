"""gppvae_tpu_torch/utils/prng.py against jax.random, with x64 off.

The JAX package's production stream is x64-off (tests/conftest.py turns
x64 on for the whole tier; a large seed's PRNGKey and randint's dtype
differ under it), so every comparison here runs inside
`jax.enable_x64(False)`. Bit-exact: keys, bits, uniform, normal (its
table of every value it can draw, whole), randint,
permutation, truncated_normal at (−2, 2) (flax's) and (−1, 3). flax's init of the VAE and
the CVAE from one key: the port's tree equals `model.init`'s to 1e-7
absolute (in fact exactly). chip_smoke.py's PRNG_GOLDEN, which the card's
machine (no jax) checks the port against, is jax.random's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gppvae_tpu.models.cvae import CVAE as FlaxCVAE
from gppvae_tpu.models.vae import VAE as FlaxVAE
from gppvae_tpu_torch.convert import flax_to_state_dict
from gppvae_tpu_torch.models import CVAE, VAE
from gppvae_tpu_torch.train import batching
from gppvae_tpu_torch.utils import prng

SEEDS = [0, 7, 123456789, 2**31 + 5, 2**32 + 3]


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


# k1 ^ k2 ^ 0x1BD11BDA = 2³² − 1: the hash's key-schedule sums wrap
WRAP_SEED = 0xFFFFFFFF ^ 0x1BD11BDA


@pytest.mark.parametrize("seed", [*SEEDS, WRAP_SEED])
def test_keys_split_fold_in(seed):
    jk, pk = _key(seed)
    np.testing.assert_array_equal(pk, np.asarray(jk))
    for num in (2, 3, 4, 45):
        np.testing.assert_array_equal(prng.split(pk, num), np.asarray(jax.random.split(jk, num)))
    for data in (0, 1, 2, 3, 99, 2**31 + 1):
        np.testing.assert_array_equal(prng.fold_in(pk, data),
                                      np.asarray(jax.random.fold_in(jk, data)))
    stack = prng.split(pk, 5)
    np.testing.assert_array_equal(prng.fold_in(stack, 9),
                                  np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(
                                      jax.random.split(jk, 5))))


@pytest.mark.parametrize("seed", SEEDS[1:3])
@pytest.mark.parametrize("shape", [(), (7,), (2, 3, 4)])
def test_bits_uniform_normal(seed, shape):
    jk, pk = _key(seed)
    np.testing.assert_array_equal(prng.random_bits(pk, shape),
                                  np.asarray(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(prng.uniform(pk, shape),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(prng.uniform(pk, shape, -1.3, 2.9),
                                  np.asarray(jax.random.uniform(jk, shape, minval=-1.3,
                                                                maxval=2.9)))
    np.testing.assert_array_equal(prng.normal(pk, shape),
                                  np.asarray(jax.random.normal(jk, shape, jnp.float32)))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_many_normals_and_a_stack_of_keys(seed):
    """200,000 normals (both erf⁻¹ branches, log1p's two) and one epoch's
    ε drawn for 45 step keys at once, as the trainers draw them."""
    jk, pk = _key(seed)
    np.testing.assert_array_equal(prng.normal(pk, (200_000,)),
                                  np.asarray(jax.random.normal(jk, (200_000,), jnp.float32)))
    keys = jax.random.split(jax.random.fold_in(jk, 1), 45)
    want = jax.vmap(lambda k: jax.random.normal(k, (128, 16), jnp.float32))(keys)
    np.testing.assert_array_equal(prng.normal(np.asarray(keys), (128, 16)), np.asarray(want))


def test_normal_table_holds_every_draw():
    """normal's table against XLA's √2·erf⁻¹ of each of the 2²³ values u
    that jax.random.normal can draw (its uniform's 23 kept bits), so that
    no draw of any key can differ."""
    m = jnp.arange(1 << 23, dtype=jnp.uint32)
    f = jax.lax.bitcast_convert_type(m | jnp.uint32(0x3F800000), jnp.float32) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = jnp.maximum(lo, f * (np.float32(1.0) - lo) + lo)
    want = np.asarray(jax.jit(lambda u: np.float32(np.sqrt(2)) * jax.lax.erf_inv(u))(u))
    np.testing.assert_array_equal(prng._normal_table(), want)


def test_erfinv_edges():
    x = np.array([-1.0, 1.0, 0.0, 1e-30, -0.99999994, 0.5], np.float32)
    np.testing.assert_array_equal(prng.erfinv(x), np.asarray(jax.lax.erf_inv(jnp.asarray(x))))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_truncated_normal(seed):
    jk, pk = _key(seed)
    for lo, hi in ((-2.0, 2.0), (-1.0, 3.0)):
        np.testing.assert_array_equal(
            prng.truncated_normal(pk, lo, hi, (50_000,)),
            np.asarray(jax.random.truncated_normal(jk, lo, hi, (50_000,), jnp.float32)))


@pytest.mark.parametrize("seed", SEEDS[::2])
@pytest.mark.parametrize("lo,hi", [(0, 400), (-5, 1000), (3, 3), (0, 2**31 - 1)])
def test_randint(seed, lo, hi):
    jk, pk = _key(seed)
    got = prng.randint(pk, (257,), lo, hi)
    want = np.asarray(jax.random.randint(jk, (257,), lo, hi))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n", [1, 2, 128, 5700])
def test_permutation(seed, n):
    jk, pk = _key(seed)
    np.testing.assert_array_equal(prng.permutation(pk, n),
                                  np.asarray(jax.random.permutation(jk, n)))
    x = np.arange(n, dtype=np.int32) * 3 + 11  # an index array: its entries shuffled
    np.testing.assert_array_equal(prng.permutation(pk, x),
                                  np.asarray(jax.random.permutation(jk, jnp.asarray(x))))


def test_epoch_batches_is_the_jax_plan():
    """train/batching.epoch_batches: the JAX package's plan, padding and
    weights at a non-divisible N."""
    from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches

    jk, pk = _key(3)
    jb, jw = jax.jit(jax_epoch_batches, static_argnums=(1, 2))(jk, 171, 16)
    b, w = batching.epoch_batches(pk, 171, 16)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_fold_in_str_is_flax_fold_in_static():
    from flax.core.scope import _fold_in_static

    jk, pk = _key(11)
    for data in (("encoder", "Conv_0", 1), ("decoder", "head_mu", 2), (300,), ("a",)):
        np.testing.assert_array_equal(prng.fold_in_str(pk, *data),
                                      np.asarray(_fold_in_static(jk, data)))


def test_flax_init_of_the_vae():
    """At the golden widths; the published ones: test_chip_smoke_constants."""
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    fm = FlaxVAE(zdim=6, image_shape=(32, 32, 1), enc_features=(8, 16), dec_features=(16, 8))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax.jit(fm.init)(
        keys[1], jnp.zeros((1, 32, 32, 1)), keys[2])))
    got = VAE(6, (32, 32, 1), (8, 16), (16, 8), key=np.asarray(keys[1])).state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_flax_init_of_the_cvae():
    fm = FlaxCVAE(zdim=6, image_shape=(32, 32, 1), num_views=8, enc_features=(8, 16),
                  dec_features=(16, 8))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax.jit(fm.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,), jnp.int32),
        jax.random.PRNGKey(1))))
    got = CVAE(6, (32, 32, 1), 8, (8, 16), (16, 8), key=4).state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_chip_smoke_constants_are_jax_random():
    """PRNG_GOLDEN, which path 12 holds the port to on the card, from
    jax.random and flax here."""
    g = chip_smoke.PRNG_GOLDEN
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    np.testing.assert_array_equal(np.asarray(keys), np.array(g["split"], np.uint32))
    epoch_key = jax.random.fold_in(keys[0], 0)
    perm = jax.random.permutation(epoch_key, 5700)
    eps = jax.vmap(lambda k: jax.random.normal(k, (128, 16), jnp.float32))(
        jax.random.split(jax.random.fold_in(epoch_key, 1), 45))
    got = chip_smoke.stream_fingerprint(torch.from_numpy(np.array(perm)),
                                        torch.from_numpy(np.array(eps)), 5700)
    assert got == {k: g[k] for k in got}
    init = jax.jit(FlaxVAE(zdim=16, image_shape=(32, 32, 1)).init)(
        keys[1], jnp.zeros((1, 32, 32, 1)), keys[2])
    sd = flax_to_state_dict(jax.tree.map(np.asarray, init))
    assert {k: float(np.abs(v.numpy()).sum(dtype=np.float64)) for k, v in sd.items()
            if k.endswith("weight")} == g["init_abs_sums"]
