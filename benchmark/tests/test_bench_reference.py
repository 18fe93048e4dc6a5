"""The plain reference against the formulas it states and against the
program, on the CPU at a tiny size, both sides given the same inputs."""

from __future__ import annotations

import math

import pytest
import torch
from conftest import ROOT  # noqa: F401

from benchmark.harness import checks, datagen, weights
from benchmark.reference import gppvae as ref

MODEL = {"zdim": 4, "enc_features": [8, 16], "dec_features": [16, 8], "obj_feature_dim": 3,
         "view_num_freqs": 1, "dec_upsample": "resize", "compute_dtype": "float32"}
TRAIN = {"sigma_y": 0.1, "sat_penalty": 1.0, "lr_vae": 2e-4, "lr_gp": 1e-3,
         "clip_grad_norm": 1e5, "init_v_sig": 1.0, "init_v_noise": 0.5}
DATA = {"kind": "rotated_digits", "num_objects": 6, "num_views": 4, "image_size": 32,
        "heldout_per_object": 1, "val_fraction": 0.05}


@pytest.fixture(scope="module")
def case():
    grid = datagen.make_grid(DATA, 2**31 + 5, "cpu")
    vae, gp = weights.make(ref, MODEL, TRAIN, grid, 2**31 + 5, "cpu")
    return grid, vae, gp


def test_woodbury_nll_equals_the_dense_gaussian():
    g = torch.Generator().manual_seed(0)
    N, R, L = 30, 6, 3
    V = torch.randn(N, R, generator=g, dtype=torch.float64)
    Z = torch.randn(N, L, generator=g, dtype=torch.float64)
    log_vs, log_vn = torch.tensor([0.3], dtype=torch.float64), torch.tensor(-0.7, dtype=torch.float64)
    vs, vn = ref.variances(log_vs, log_vn)
    K = vs * V @ V.T + vn * torch.eye(N, dtype=torch.float64)
    dense = 0.5 * (L * torch.logdet(K) + torch.trace(Z.T @ torch.linalg.solve(K, Z))
                   + N * L * math.log(2 * math.pi))
    assert float(ref.nll(Z, V, log_vs, log_vn)) == pytest.approx(float(dense), rel=1e-12)
    M = ref.posterior_core(Z, V, log_vs, log_vn)
    # z* of a training row's own features: K(*, ·) K⁻¹ Z
    Kstar = vs * V[:5] @ V.T
    assert torch.allclose(torch.sqrt(vs) * V[:5] @ M, Kstar @ torch.linalg.solve(K, Z),
                          atol=1e-10)


def test_vae_matches_the_program_in_float32(case):
    from gppvae_tpu_torch.models import VAE

    grid, vae, _ = case
    shape = tuple(grid["images"].shape[1:])
    model = VAE(MODEL["zdim"], shape, MODEL["enc_features"], MODEL["dec_features"], "resize")
    model.load_state_dict(vae)
    y = grid["images"][:10]
    a = ref.Arith("exact")
    with torch.no_grad():
        mu, logvar = model.encode(y)
        rmu, rlogvar = ref.encode(vae, y, a, 2)
        assert checks.rel(mu, rmu) < 1e-5 and checks.rel(logvar, rlogvar) < 1e-5
        logits = model.decode(mu)
        assert checks.rel(logits, ref.decode(vae, rmu, a, shape, MODEL["dec_features"])) < 1e-5


def test_taylor_coefficients_match_the_program(case):
    from gppvae_tpu_torch import gp as pgp

    grid, _, gp0 = case
    tr = torch.as_tensor(grid["train_idx"], dtype=torch.int64)
    d = torch.as_tensor(grid["object_ids"], dtype=torch.int64)[tr]
    q = torch.as_tensor(grid["view_ids"], dtype=torch.int64)[tr]
    Z = torch.randn(len(tr), 4, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    p = {k: v.double() for k, v in gp0.items()}
    V = pgp.build_effect_rows(p["X"], p["W"], d, q)

    def nll_fn(Z, Vs, aux):
        v_sig, v_noise = pgp.variances_from_log(aux["log_vs"], aux["log_vn"])
        return pgp.gp_nll_from_features(Z, Vs, [v_sig[0]], v_noise)

    c = pgp.taylor_expand(nll_fn, Z, V, {"log_vs": p["log_vs"], "log_vn": p["log_vn"]})
    r = ref.taylor(Z, ref.feature_rows(p["X"], p["W"], d, q), p["log_vs"], p["log_vn"])
    assert float(c.value) == pytest.approx(float(r["value"]), rel=1e-10)
    for got, want in ((c.dZ, r["dZ"]), (c.dV[0], r["dV"]), (c.daux["log_vs"], r["dlog_vs"]),
                      (c.daux["log_vn"], r["dlog_vn"])):
        assert checks.rel(got, want) < 1e-9


def test_fp8_rounds_to_three_mantissa_bits():
    a = ref.Arith("fp8")
    x = torch.tensor([1.0, 1.1, 448.0, -3.3], requires_grad=True)  # the scale is 1
    y = a.q(x)
    assert y.detach().tolist() == [1.0, 1.125, 448.0, -3.25]
    y.sum().backward()  # the gradient passes straight through
    assert torch.equal(x.grad, torch.ones(4))


@pytest.mark.parametrize("cell", ["faces128_train", "faces128_serve"])
def test_a_float32_run_agrees_with_the_reference(tiny, cell):
    """A run of the program at a tiny size on the CPU, judged against the
    reference by the committed limits. update_gap is held to 1e-2 here: at
    this size W has 15 entries, and the part of W's gradient along each row,
    which the rows' normalisation makes nought, is round-off that Adam's
    first steps turn into a step of lr either way; among the 63 entries of
    the full size (and the full VAE) it reads 1e-5 (PERF.md). The serving
    window is long enough to keep a reply on a loaded host: a window with
    none reads as infinitely far."""
    from benchmark import run

    seconds = 1.0 if tiny.traffic(tiny.workload(cell)["traffic"])["kind"] == "serve" else 0.2
    out = run.run_cell(tiny, cell, 2**31 + 77, seconds, False, torch.device("cpu"))
    for name, row in out["checks"].items():
        assert row["value"] <= (1e-2 if name == "update_gap" else row["limit"]), (name, row)
