"""The port's GP hot ops (gppvae_tpu_torch.ops) against gppvae_tpu.ops.

Inputs are made with numpy from a seed; the same arrays go through the JAX
function (XLA, and the Pallas kernel in interpret mode) and the port's
dispatch, which on CPU tensors runs the plain version inside the same
autograd.Function the CUDA kernel uses. Tolerances, by dtype:
  * float32: rtol 2e-5 / atol 1e-4 for factor_prep (sums of N products in
    another order), rtol 3e-6 for the NLL value and rtol 2e-4 / atol 1e-6
    for its gradients (the bounds tests/test_pallas_ops.py holds the Pallas
    kernels to);
  * float64: rtol 1e-12 for factor_prep, 1e-10 for the NLL and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gppvae_tpu import ops as jops
from gppvae_tpu.ops.dispatch import _xla_woodbury_nll_core
from gppvae_tpu.ops.pallas_chol import nll_core_pallas
from gppvae_tpu_torch import ops
from _one_thread import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # run the JAX package's Pallas kernels in interpret mode on the CPU
    monkeypatch.setenv("GPPVAE_PALLAS_INTERPRET", "1")


def _rows(n, r, l, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, r)).astype(dtype),
            rng.standard_normal((n, l)).astype(dtype))


def _tol(dtype):
    return (dict(rtol=2e-5, atol=1e-4) if dtype == np.float32
            else dict(rtol=1e-12, atol=1e-9))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,r,l", [
    (6400, 56, 16),  # the benchmark shape
    (999, 56, 16),   # nothing aligned
    (64, 3, 1),      # tiny
    (513, 56, 16),   # ragged N: one row past the TPU kernel's 512-row tile
])
def test_factor_prep_matches_jax(impl, dtype, n, r, l):
    U, Z = _rows(n, r, l, dtype)
    want = jops.factor_prep(jnp.asarray(U), jnp.asarray(Z), impl=impl)
    got = ops.factor_prep(torch.from_numpy(U), torch.from_numpy(Z))
    assert got[2].shape == ()  # a 0-d ‖Z‖², never the kernel's (1, 1) block
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_tol(dtype))
    plain = ops.factor_prep_torch(torch.from_numpy(U), torch.from_numpy(Z))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g.numpy(), p.numpy())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_factor_prep_gradients_match_jax(impl):
    U, Z = _rows(300, 20, 7, np.float32, seed=1)
    rng = np.random.default_rng(5)
    A = rng.standard_normal((20, 20)).astype(np.float32)  # asymmetric cotangent
    B = rng.standard_normal((20, 7)).astype(np.float32)

    def jloss(U, Z):
        G, UtZ, zn = jops.factor_prep(U, Z, impl=impl)
        return jnp.sum(G * A) + jnp.sum(UtZ * B) + 3.0 * zn

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(U), jnp.asarray(Z))
    tU = torch.from_numpy(U).requires_grad_()
    tZ = torch.from_numpy(Z).requires_grad_()
    G, UtZ, zn = ops.factor_prep(tU, tZ)
    loss = torch.sum(G * torch.from_numpy(A)) + torch.sum(UtZ * torch.from_numpy(B)) + 3.0 * zn
    got = torch.autograd.grad(loss, (tU, tZ))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _core_problem(r, l, dtype, n=500, seed=1):
    U, Z = _rows(n, r, l, dtype, seed)
    return (U.T @ U, U.T @ Z, dtype(np.sum(Z * Z)), dtype(0.37)), n


def _jax_core(impl, n, l):
    if impl == "xla":
        return lambda G, UtZ, zn, vn: _xla_woodbury_nll_core(G, UtZ, zn, vn, n, l)
    return lambda G, UtZ, zn, vn: nll_core_pallas(G, UtZ, zn, vn, n, l)


@pytest.mark.parametrize("impl,dtype", [
    ("xla", np.float32), ("pallas", np.float32), ("xla", np.float64),
])
@pytest.mark.parametrize("r,l", [(24, 9), (56, 16), (3, 1)])
def test_nll_core_value_and_gradients_match_jax(impl, dtype, r, l):
    args, n = _core_problem(r, l, dtype)
    val, grads = jax.value_and_grad(_jax_core(impl, n, l), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    out = ops.woodbury_nll_core(*leaves, n, l)
    got = torch.autograd.grad(out, leaves)  # the closed-form backward
    f32 = dtype == np.float32
    np.testing.assert_allclose(out.item(), float(val), rtol=3e-6 if f32 else 1e-10)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=2e-4 if f32 else 1e-10,
                                   atol=1e-6 if f32 else 1e-12)


def test_nll_core_above_the_tpu_kernel_range_matches_xla():
    """R = 600, past the Pallas kernel's 512: the JAX package runs it through
    XLA, and the port's CUDA kernel takes it too. Here the port's dispatch
    (the plain version inside the autograd.Function) against that XLA path,
    float64."""
    args, n = _core_problem(600, 16, np.float64, n=900, seed=2)
    val, grads = jax.value_and_grad(_jax_core("xla", n, 16), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    out = ops.woodbury_nll_core(*leaves, n, 16)
    np.testing.assert_allclose(out.item(), float(val), rtol=1e-10)
    for g, w in zip(torch.autograd.grad(out, leaves), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


def test_closed_form_backward_matches_autograd_of_plain_version():
    args, n = _core_problem(24, 9, np.float64, seed=3)
    a = [torch.tensor(np.asarray(x)).requires_grad_() for x in args]
    b = [torch.tensor(np.asarray(x)).requires_grad_() for x in args]
    ga = torch.autograd.grad(ops.woodbury_nll_core(*a, n, 9), a)
    gb = torch.autograd.grad(ops.woodbury_nll_core_torch(*b, n, 9), b)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10, atol=1e-12)


def test_nll_core_residuals_are_the_inverse_factor():
    args, n = _core_problem(12, 5, np.float64, seed=4)
    G, UtZ, zn, vn = (torch.tensor(np.asarray(x)) for x in args)
    _, X, W = ops.nll_core_torch(G, UtZ, zn, vn, n, 5)
    B = torch.eye(12, dtype=torch.float64) + G / vn
    np.testing.assert_allclose((X.T @ X @ B).numpy(), np.eye(12), atol=1e-10)
    np.testing.assert_allclose((X.T @ W).numpy(), torch.linalg.solve(B, UtZ).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    U, Z = (torch.from_numpy(a).requires_grad_() for a in _rows(200, 6, 3, np.float32))
    G, UtZ, zn = ops.factor_prep(U, Z)
    nll = ops.woodbury_nll_core(G, UtZ, zn, torch.tensor(0.5), 200, 3)
    nll.backward()
    assert U.grad is not None and torch.isfinite(U.grad).all()
    assert ops.launch_counts() == {
        "launch_factor_prep.launches": 0, "launch_nll_core.launches": 0,
        "factor_prep_torch.cuda_calls": 0, "nll_core_torch.cuda_calls": 0,
        "launch_conv3x3.fprop": 0, "launch_conv3x3.dgrad": 0, "launch_conv3x3.wgrad": 0,
        "conv3x3_torch.cuda_calls": 0,
    }


def test_other_devices_raise():
    U = torch.empty((8, 3), device="meta")
    Z = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.factor_prep(U, Z)
    G = torch.empty((3, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.woodbury_nll_core(G, Z[:3], torch.empty((), device="meta"),
                              torch.empty((), device="meta"), 8, 2)


def test_kernel_build_raises_without_a_working_nvcc(monkeypatch, tmp_path):
    from gppvae_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_kernel_wrappers_refuse_cpu_tensors():
    U, Z = (torch.from_numpy(a) for a in _rows(8, 3, 2, np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_factor_prep(U, Z)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch_nll_core(U.T @ U, U.T @ Z, torch.tensor(1.0), torch.tensor(1.0), 8, 2)
