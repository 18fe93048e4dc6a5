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

import numpy as np
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
    # the bench's large N, R across the tensor-core tiles (57: the 4-byte
    # copies), L = 1, N shorter than one 32-row stage
    (262144, 256, 16, 0), (5700, 57, 16, 0), (5700, 130, 16, 0), (5700, 56, 1, 0),
    (20, 56, 16, 0),
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


def test_factor_prep_kernel_refuses_float64(gen):
    U = torch.randn(64, 8, device="cuda", generator=gen, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ops.launch_factor_prep(U, U[:, :2])


def _planned_driver(r, l):
    """The driver ops.nll_core's plan picks for (R, L) on this card."""
    from gppvae_tpu_torch.ops import _build
    from gppvae_tpu_torch.ops.nll_core import plan_nll_core

    return plan_nll_core(r, l, _build.device_props(torch.cuda.current_device())).driver


@pytest.mark.parametrize("r,l", [
    (56, 16), (3, 1), (225, 16), (232, 32), (234, 16), (235, 16), (256, 16),
    (512, 8), (560, 16), (600, 16), (1024, 16), (2048, 8),
    # each driver's band with a ragged R, and either side of the cut-overs
    (127, 16), (128, 16), (129, 16), (233, 16), (479, 16), (480, 16), (481, 16),
    (561, 16), (1000, 16), (1100, 16),
])
def test_nll_core_kernel_matches_plain(gen, r, l):
    """Each of the kernel's three drivers (one CTA, a cluster, a cooperative
    grid), as the plan picks them; the launch runs the planned one."""
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
    before = ops.driver_counts()
    first = ops.launch_nll_core(G, UtZ, zn, vn, n, l)
    again = ops.launch_nll_core(G, UtZ, zn, vn, n, l)
    ran = {d: c - before[d] for d, c in ops.driver_counts().items() if c != before[d]}
    assert ran == {_planned_driver(r, l): 2}
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(first[1], torch.tril(first[1]))  # X = L_B⁻¹ is lower triangular


def test_cluster_driver_reruns_bit_for_bit(gen):
    """The cluster driver sums in a fixed order across its CTAs' shared
    memory: five launches at a ragged R give the same bits."""
    n, r, l = 6400, 233, 16
    assert _planned_driver(r, l) == "cluster"
    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    G, UtZ, zn = ops.factor_prep_torch(U, Z)
    vn = torch.tensor(0.4, device="cuda")
    outs = [ops.launch_nll_core(G, UtZ, zn, vn, n, l) for _ in range(5)]
    assert all(torch.equal(a, b) for out in outs[1:] for a, b in zip(outs[0], out))


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


@pytest.mark.parametrize("r,driver", [(8, "cta"), (300, "cluster"), (600, "grid")])
def test_non_positive_pivot_gives_nan(gen, r, driver):
    assert _planned_driver(r, 2) == driver
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


def test_factor_prep_per_shard_on_two_gloo_ranks(gen):
    """factor_prep with a group: 2 gloo ranks on cuda:0 (NCCL takes one rank
    per card), each launching the kernel on its half of N = 5701 rows (2851
    and 2850) before the all-reduce, against the single-process kernel over
    all rows; values and gradients of sum(G²) + sum(UᵀZ) + ‖Z‖² ≤ 1e-5 of
    the largest |entry| (fp32 partial sums in another order)."""
    from gppvae_tpu_torch.parallel import run_ranks
    from gppvae_tpu_torch.parallel.dryrun import factor_prep_rank

    U = torch.randn(5701, 56, device="cuda", generator=gen) / math.sqrt(56)
    Z = torch.randn(5701, 16, device="cuda", generator=gen)
    ranks = run_ranks(factor_prep_rank, 2, backend="gloo", device="cuda:0",
                      args=(U.cpu().numpy(), Z.cpu().numpy()))
    u, z = U.clone().requires_grad_(), Z.clone().requires_grad_()
    G, UtZ, zn = ops.factor_prep(u, z)
    dU, dZ = torch.autograd.grad(torch.sum(G * G) + torch.sum(UtZ) + zn, (u, z))
    for r in ranks:
        assert r["launches"]["launch_factor_prep.launches"] == 1
        assert r["launches"]["factor_prep_torch.cuda_calls"] == 0
        for name, want in (("G", G), ("UtZ", UtZ), ("zn", zn)):
            assert _rel_err(torch.from_numpy(r[name]), want.detach().cpu()) <= 1e-5, name
    for name, want in (("dU", dU), ("dZ", dZ)):
        got = torch.from_numpy(np.concatenate([r[name] for r in ranks]))
        assert _rel_err(got, want.cpu()) <= 1e-5, name


def _synchronising(fn):
    """(synchronising calls CUDA's sync debug mode warns about in fn(), the
    port's host_sync count over the same call)."""
    import warnings

    from gppvae_tpu_torch.utils import timers

    # set before the warnings are caught: the first switch of a process
    # warns once itself (torch/cuda/__init__.py's set_sync_debug_mode)
    torch.cuda.set_sync_debug_mode("warn")
    before = timers.TRACER.counts.get("host_sync", 0)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    warned = sum("synchroniz" in str(w.message) for w in caught)
    return warned, timers.TRACER.counts.get("host_sync", 0) - before


def test_every_host_sync_of_a_step_and_a_request_is_counted(gen):
    """Each synchronising call of a Phase C step and of a predict_images
    call goes through the tracer's read, so `host_sync` counts them all.
    Neither makes one: a step fills σ_y in on the card and both guarded
    Adams decide the skip and the clip there, so the host runs ahead."""
    from gppvae_tpu_torch.eval.serving import build_server_state, predict_images

    ds = build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=7)
    cfg = train_gppvae.GPPVAETrainConfig(zdim=6, epochs=1, batch_size=16, obj_feature_dim=4,
                                         view_num_freqs=2, enc_features=(8, 16),
                                         dec_features=(16, 8))
    res = train_gppvae.train_gppvae(ds, cfg, device="cuda", log=_Quiet())
    loop = train_gppvae._Loop(res.model, res.gp_params, res.fixed_W, res.data,
                              len(ds.train_idx), cfg)
    coeffs = loop.solve(loop.encode())
    batches, w, eps = train_gppvae.make_draws(train_gppvae.run_keys(0)[0], len(ds.train_idx),
                                              16, 6)(0)
    steps = loop.epoch_steps(batches, w, eps)
    loop.minibatch_step(coeffs, *steps[0])
    torch.cuda.synchronize()
    assert _synchronising(lambda: loop.minibatch_step(coeffs, *steps[1])) == (0, 0)
    d = res.data
    params = {"vae": res.model.state_dict(),
              "gp": {k: v.detach() for k, v in res.gp_params.items()}}
    state = build_server_state(res.model, params, None, d["images_tr"], d["d_tr"], d["q_tr"])
    dd, qq = (torch.tensor([0, 3, 5], device="cuda") for _ in range(2))
    predict_images(res.model, state, dd, qq)
    torch.cuda.synchronize()
    assert _synchronising(lambda: predict_images(res.model, state, dd, qq)) == (0, 0)


def test_a_non_finite_step_is_skipped_on_the_card(gen):
    """A NaN gradient on the card: the fused update leaves the parameters,
    both moments and the step count as they were, `notfinite_count` reads
    the int 1, and the step itself makes no synchronising call. A clipped
    step then equals the same optimizer's on the CPU."""
    from gppvae_tpu_torch.train.optim import GuardedAdam

    shapes = [(64, 32), (32,), (3, 3, 8, 8)]
    ps = [torch.nn.Parameter(torch.randn(s, device="cuda", generator=gen)) for s in shapes]
    cpu = [torch.nn.Parameter(p.detach().cpu()) for p in ps]
    opt, ref = GuardedAdam(ps, lr=1e-2, clip_grad_norm=1e3), GuardedAdam(cpu, lr=1e-2,
                                                                          clip_grad_norm=1e3)

    def feed(scale, nan=False):
        for p, q in zip(ps, cpu):
            p.grad = torch.randn(p.shape, device="cuda", generator=gen) * scale
            q.grad = p.grad.cpu()
        if nan:
            ps[1].grad[3] = float("nan")
            cpu[1].grad[3] = float("nan")

    feed(1.0)
    opt.step()
    ref.step()
    before = [(p.detach().clone(), {k: v.clone() for k, v in opt.adam.state[p].items()})
              for p in ps]
    feed(1.0, nan=True)
    torch.cuda.synchronize()
    moved = []
    assert _synchronising(lambda: moved.append(opt.step())) == (0, 0)
    ref.step()
    assert moved[0].device.type == "cuda" and not bool(moved[0])
    for p, (was, state) in zip(ps, before):
        assert torch.equal(p, was)
        for k, v in state.items():
            assert torch.equal(opt.adam.state[p][k], v), k
    assert float(opt.adam.state[ps[0]]["step"]) == 1.0
    n = opt.notfinite_count
    assert type(n) is int and n == 1 and opt.steps == 1
    feed(1e6)  # far above the clip
    assert bool(opt.step()) and bool(ref.step())
    for p, q in zip(ps, cpu):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=1e-6, atol=1e-7)
    assert (opt.notfinite_count, opt.steps) == (ref.notfinite_count, ref.steps) == (1, 2)
