"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where torch finds no CUDA device (decided in
the fixture, not at import). This file imports no jax, so on a machine with
a GPU and no jax it runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances (float32 on the card): factor_prep max abs err ≤ 1e-5 of the
largest |entry| (fp32 sums in another order); nll_core value rtol 1e-5 and
gradients ≤ 1e-4 of the largest |entry|; the subpixel decoder against the
resize decoder with the same weights ≤ 1e-5 of max |·| (cuDNN, TF32 off); a
GP NLL trained on the card against CPU float64 rtol 1e-4. Both kernels sum
in a fixed order, so reruns are bit-identical.
"""

import math

import pytest
import torch

from gppvae_tpu_torch import ops
from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.train import train_gppvae

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("n,r,l,offset", [
    (5700, 56, 16, 0), (5701, 56, 16, 0), (1, 3, 1, 0), (127, 64, 64, 0),
    (6401, 256, 16, 0), (256, 2048, 8, 0), (332, 232, 32, 0), (5700, 560, 16, 0),
    (5700, 56, 16, 1),  # 4-byte aligned only: the scalar copies
])
def test_factor_prep_kernel_matches_plain(gen, n, r, l, offset):
    U = torch.randn(n * r + offset, device="cuda", generator=gen)[offset:].view(n, r)
    U.mul_(1 / math.sqrt(r))  # in place: keeps the offset
    Z = torch.randn(n * l + offset, device="cuda", generator=gen)[offset:].view(n, l)
    assert U.is_contiguous() and (U.data_ptr() % 16 != 0) == bool(offset)
    got = ops.launch_factor_prep(U, Z)
    again = ops.launch_factor_prep(U, Z)
    want = ops.factor_prep_torch(U, Z)
    assert got[2].shape == ()
    assert torch.equal(got[0], got[0].T)  # G's lower triangle, mirrored
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # fixed-order reduction: bit-identical reruns
        assert _rel_err(g, w) <= 1e-5


@pytest.mark.parametrize("r,l", [
    (56, 16), (3, 1), (225, 16), (232, 32), (234, 16), (235, 16), (256, 16),
    (512, 8), (560, 16), (600, 16), (1024, 16), (2048, 8),
])
def test_nll_core_kernel_matches_plain(gen, r, l):
    """Both drivers of the kernel: one CTA up to R = 234, one cooperative
    launch above."""
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
    first = ops.launch_nll_core(G, UtZ, zn, vn, n, l)
    again = ops.launch_nll_core(G, UtZ, zn, vn, n, l)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(first[1], torch.tril(first[1]))  # X = L_B⁻¹ is lower triangular


def test_nll_core_kernel_refuses_float64(gen):
    one = torch.tensor(1.0, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ops.woodbury_nll_core(torch.eye(4, device="cuda", dtype=torch.float64),
                              torch.zeros(4, 2, device="cuda", dtype=torch.float64),
                              one, one, 10, 2)


def test_cuda_trains_at_rank_above_512(gen):
    """112 RFF features × 5 view features = R 560, past the TPU kernel's
    512: one joint epoch on the card launches each kernel once, and the
    trained model's GP NLL from the kernels matches CPU float64."""
    from gppvae_tpu_torch import gp
    from gppvae_tpu_torch.models import encode_all

    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=7)
    cfg = train_gppvae.GPPVAETrainConfig(
        zdim=6, epochs=1, batch_size=16, obj_feature_dim=4, view_num_freqs=2,
        enc_features=(8, 16), dec_features=(16, 8), object_kernel="rbf", rff_features=112)
    ops.reset_launch_counts()
    res = train_gppvae.train_gppvae(ds, cfg, device="cuda", log=_Quiet())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["launch_factor_prep.launches"] == counts["launch_nll_core.launches"] == 1
    assert counts["factor_prep_torch.cuda_calls"] == counts["nll_core_torch.cuda_calls"] == 0
    assert all(math.isfinite(v) for v in res.history[0].values() if isinstance(v, float))
    d, p = res.data, res.gp_params
    with torch.no_grad():
        Z = encode_all(res.model, d["images_tr"], 1024)
        Vs = gp.build_effect_rows(p["X"], p["W"], d["d_tr"], d["q_tr"], x_map=res.x_map)
        v_sig, v_noise = gp.variances_from_log(p["log_vs"], p["log_vn"])
        assert sum(v.shape[1] for v in Vs) == 560
        card = float(gp.gp_nll_from_features(Z, Vs, [v_sig[0]], v_noise))
        cpu = float(gp.gp_nll_from_features(Z.cpu().double(), [Vs[0].cpu().double()],
                                            [v_sig[0].cpu().double()], v_noise.cpu().double()))
    assert abs(card - cpu) <= 1e-4 * abs(cpu)


class _Quiet:
    def log(self, rec):
        pass


def test_serving_on_card_matches_cpu_float64(gen):
    """A state folded on the card from a model trained there (rbf kernel,
    extra object effect) serves the held-out cells: images within 1e-5 and
    variances within rel 1e-5 of the same fold and prediction in float64 on
    the CPU; no kernel launches on the serving path; every state tensor on
    the card; the sustained-throughput chain returns a positive rate."""
    import copy

    from gppvae_tpu_torch.eval import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=7)
    cfg = train_gppvae.GPPVAETrainConfig(
        zdim=6, epochs=1, batch_size=16, obj_feature_dim=4, view_num_freqs=2,
        enc_features=(8, 16), dec_features=(16, 8), object_kernel="rbf", rff_features=8,
        extra_effects=("object",))
    res = train_gppvae.train_gppvae(ds, cfg, device="cuda", log=_Quiet())
    d, extra = res.data, cfg.extra_effects
    params = {"vae": res.model.state_dict(),
              "gp": {k: v.detach() for k, v in res.gp_params.items()}}
    ops.reset_launch_counts()
    state = serving.build_server_state(res.model, params, None, d["images_tr"], d["d_tr"],
                                       d["q_tr"], x_map=res.x_map, extra_effects=extra)
    y, var = serving.predict_images(res.model, state, d["d_ho"], d["q_ho"], x_map=res.x_map,
                                    extra_effects=extra, return_var=True)
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}
    assert all(t.is_cuda for t in (*state.core, state.X, state.W, state.v_sig,
                                   *state.vae_params.values()))

    cpu = copy.deepcopy(res.model).cpu().double()
    cpu.dtype = torch.float64

    def f64(tree):
        return {k: v.detach().cpu().double() for k, v in tree.items()}

    s64 = serving.build_server_state(cpu, {"vae": f64(params["vae"]), "gp": f64(params["gp"])},
                                     None, d["images_tr"].cpu().double(), d["d_tr"].cpu(),
                                     d["q_tr"].cpu(), x_map=res.x_map, extra_effects=extra)
    y64, var64 = serving.predict_images(cpu, s64, d["d_ho"].cpu(), d["q_ho"].cpu(),
                                        x_map=res.x_map, extra_effects=extra, return_var=True)
    assert float((y.cpu().double() - y64).abs().max()) <= 1e-5
    assert _rel_err(var.cpu().double(), var64) <= 1e-5

    rate = serving._sustained_throughput(
        lambda dd, qq: serving.predict_images(res.model, state, dd, qq, x_map=res.x_map,
                                              extra_effects=extra),
        d["d_ho"], d["q_ho"], 10, 8, 3)
    assert rate["sustained_images_per_sec"] > 0


@pytest.mark.parametrize("r", [8, 600])  # each driver
def test_non_positive_pivot_gives_nan(gen, r):
    G = -4.0 * torch.eye(r, device="cuda")  # B = I + G/vn has negative pivots
    nll, X, W = ops.launch_nll_core(G, torch.ones(r, 2, device="cuda"),
                                    torch.tensor(1.0, device="cuda"),
                                    torch.tensor(1.0, device="cuda"), 10, 2)
    assert torch.isnan(nll)


@pytest.mark.parametrize("shape,enc,dec,zdim", [
    ((32, 32, 1), (32, 64, 128), (128, 64, 32), 16),  # the digits configs
    ((128, 128, 3), (32, 64, 128), (128, 64, 32), 32),  # face-view 128²
])
def test_subpixel_decoder_matches_resize_on_card(gen, shape, enc, dec, zdim):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resize = VAE(zdim, shape, enc, dec, "resize").cuda()
    sub = VAE(zdim, shape, enc, dec, "subpixel").cuda()
    sub.load_state_dict(resize.state_dict())
    z = torch.randn(64, zdim, device="cuda", generator=gen)
    a, b = resize.decode(z), sub.decode(z)
    assert a.shape == b.shape == (64, *shape)
    assert _rel_err(b, a) <= 1e-5
    torch.sum(a * a).backward()
    torch.sum(b * b).backward()
    for (name, p), q in zip(resize.named_parameters(), sub.parameters()):
        if name.startswith("decoder."):
            assert _rel_err(q.grad, p.grad) <= 1e-5, name


@pytest.mark.parametrize("upsample", ["resize", "subpixel"])
def test_bf16_vae_outputs_are_f32_and_finite(gen, upsample):
    model = VAE(16, (32, 32, 1), upsample=upsample, dtype=torch.bfloat16).cuda()
    y = torch.rand(128, 32, 32, 1, device="cuda", generator=gen)
    mu, logvar = model.encode(y)
    logits = model.decode(mu)
    for t in (mu, logvar, logits):
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_factor_prep_refuses_bf16(gen):
    U = torch.randn(64, 8, device="cuda", generator=gen).bfloat16()
    Z = torch.randn(64, 4, device="cuda", generator=gen).bfloat16()
    with pytest.raises(TypeError, match="float32"):
        ops.factor_prep(U, Z)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_program_round_trip_on_card(gen, tmp_path, dtype):
    """`serve --export_exe` then `serve --exe` on the card at the golden
    size (rbf kernel, an extra object effect): every entry exported for
    cuda; means, variances and both kinds of draws equal the eager library
    calls on the same state within 1e-6; the observe entry's core within rel
    1e-5 of `observe`; one artifact answers b = 1 and k = 1 as well as
    larger sizes; no kernel launch; and the artifact is refused by name on a
    device it was not exported for."""
    from gppvae_tpu_torch.eval import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=7)
    cfg = train_gppvae.GPPVAETrainConfig(
        zdim=6, epochs=1, batch_size=16, obj_feature_dim=4, view_num_freqs=2,
        enc_features=(8, 16), dec_features=(16, 8), object_kernel="rbf", rff_features=8,
        extra_effects=("object",), compute_dtype=dtype)
    res = train_gppvae.train_gppvae(ds, cfg, device="cuda", log=_Quiet())
    d, kw = res.data, dict(x_map=res.x_map, extra_effects=cfg.extra_effects)
    params = {"vae": res.model.state_dict(),
              "gp": {k: v.detach() for k, v in res.gp_params.items()}}
    state = serving.build_server_state(res.model, params, None, d["images_tr"], d["d_tr"],
                                       d["q_tr"], **kw)
    exe = str(tmp_path / "m.exe")
    ops.reset_launch_counts()
    meta = serving.export_compiled_program(res.model, state, exe, **kw)
    assert meta["platforms"] == ["cuda"] and meta["compute_dtype"] == dtype
    assert sorted(meta["entry_points"]) == sorted(serving._EXE_ENTRIES)

    core, _ = serving.load_compiled_program(exe, "core", "cuda")
    for b, k in ((1, 1), (5, 3), (10, 1)):
        dd, qq = d["d_ho"][:b], d["q_ho"][:b]
        eps = torch.randn((b, k, 6), generator=torch.Generator().manual_seed(b)).cuda()
        y, var = serving.predict_images(res.model, state, dd, qq, return_var=True, **kw)
        ey, evar = serving.load_compiled_program(exe, "var", "cuda")[0](dd, qq)
        assert ey.is_cuda and ey.dtype == torch.float32 and ey.shape == (b, 32, 32, 1)
        assert float((ey - y).abs().max()) <= 1e-6 and _rel_err(evar, var) <= 1e-6
        py, _ = serving.load_compiled_program(exe, "predict_core", "cuda")[0](*core, dd, qq)
        assert float((py - y).abs().max()) <= 1e-6
        for entry, joint in (("sample", False), ("sample_joint", True)):
            want = serving.sample_images(res.model, state, dd, qq, None, k, joint=joint,
                                         eps=eps, **kw)
            got = serving.load_compiled_program(exe, entry, "cuda")[0](dd, qq, eps)
            assert got.shape == (b, k, 32, 32, 1)
            assert float((got - want).abs().max()) <= 1e-6, (entry, b, k)
    mask = torch.ones(10, device="cuda")
    mask[7:] = 0
    new = serving.load_compiled_program(exe, "observe", "cuda")[0](
        *core, d["y_ho"], d["d_ho"], d["q_ho"], mask)
    want = serving.observe(res.model, state, d["y_ho"], d["d_ho"], d["q_ho"], row_mask=mask,
                           **kw).core
    for g, w in zip(new, want):
        assert _rel_err(g, w) <= 1e-5
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}

    with pytest.raises(ValueError, match="exported for \\['cuda'\\], not for 'cpu'"):
        serving.load_compiled_program(exe, "mean", "cpu")
    with pytest.raises(ValueError, match="not for 'cpu'"):
        serving.main(["--exe", exe, "--device", "cpu", "--requests", "1:1",
                      "--outdir", str(tmp_path)])
    # exported for both: each device gets its own programs
    both = str(tmp_path / "both.exe")
    meta = serving.export_compiled_program(res.model, state, both, platforms=("cuda", "cpu"),
                                           entry_points=("mean",), **kw)
    assert meta["entry_points"]["mean"]["files"] == {"cuda": "both.exe", "cpu": "both.exe@cpu"}
    on_cpu = serving.load_compiled_program(both, "mean", "cpu")[0](d["d_ho"].cpu(),
                                                                   d["q_ho"].cpu())
    on_card = serving.load_compiled_program(both, "mean", "cuda")[0](d["d_ho"], d["q_ho"])
    # two devices' convolutions round differently, in bfloat16 at its 8 bits
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert not on_cpu.is_cuda and float((on_card.cpu() - on_cpu).abs().max()) <= tol
