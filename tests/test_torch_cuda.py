"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where torch finds no CUDA device (decided in
the fixture, not at import). This file imports no jax, so on a machine with
a GPU and no jax it runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances (float32 on the card): factor_prep max abs err ≤ 1e-5 of the
largest |entry| (fp32 sums in another order); nll_core value rtol 1e-5 and
gradients ≤ 1e-4 of the largest |entry|.
"""

import math

import pytest
import torch

from gppvae_tpu_torch import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("n,r,l", [
    (5700, 56, 16), (5701, 56, 16), (1, 3, 1), (127, 64, 64), (6401, 256, 16),
    (256, 2048, 8),
])
def test_factor_prep_kernel_matches_plain(gen, n, r, l):
    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    got = ops.launch_factor_prep(U, Z)
    again = ops.launch_factor_prep(U, Z)
    want = ops.factor_prep_torch(U, Z)
    assert got[2].shape == ()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # fixed-order reduction: bit-identical reruns
        assert _rel_err(g, w) <= 1e-5


@pytest.mark.parametrize("r,l", [(56, 16), (3, 1), (225, 16), (256, 16), (512, 8)])
def test_nll_core_kernel_matches_plain(gen, r, l):
    n = 6400
    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    G, UtZ, zn = ops.factor_prep_torch(U, Z)
    vn = torch.tensor(0.4, device="cuda")
    ka = [t.clone().requires_grad_() for t in (G, UtZ, zn, vn)]
    pa = [t.clone().requires_grad_() for t in (G, UtZ, zn, vn)]
    k = ops.woodbury_nll_core(*ka, n, l)
    p = ops.woodbury_nll_core_torch(*pa, n, l)
    assert abs(k.item() - p.item()) <= 1e-5 * abs(p.item())
    for a, b in zip(torch.autograd.grad(k, ka), torch.autograd.grad(p, pa)):
        assert _rel_err(a, b) <= 1e-4


def test_nll_core_kernel_refuses_what_it_does_not_take(gen):
    G = torch.eye(513, device="cuda")
    UtZ = torch.zeros(513, 2, device="cuda")
    one = torch.tensor(1.0, device="cuda")
    with pytest.raises(ValueError, match="R <= 512"):
        ops.woodbury_nll_core(G, UtZ, one, one, 10, 2)
    with pytest.raises(TypeError, match="float32"):
        ops.woodbury_nll_core(G[:4, :4].double(), UtZ[:4].double(), one.double(),
                              one.double(), 10, 2)


def test_non_positive_pivot_gives_nan(gen):
    G = -4.0 * torch.eye(8, device="cuda")  # B = I + G/vn has negative pivots
    nll, X, W = ops.launch_nll_core(G, torch.ones(8, 2, device="cuda"),
                                    torch.tensor(1.0, device="cuda"),
                                    torch.tensor(1.0, device="cuda"), 10, 2)
    assert torch.isnan(nll)
