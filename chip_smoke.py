#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one per printed line group; any failure ends the run non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit,
     the TF32 flags. Raises without CUDA;
  2. build: both CUDA kernels from gppvae_tpu_torch/csrc with nvcc for
     sm_90a, one nvcc per source, started together;
  3. kernel vs plain on the card: factor_prep at (N, R, L) = (5700,56,16),
     (5701,56,16), (6401,256,16), (256,2048,8), (332,232,32), (5700,560,16);
     nll_core at R = 56, 232, 560, 600, 1024, 2048 (L 16, 32, 16, 16, 16, 8).
     At each shape the
     value and the gradients through the autograd.Function against autograd
     of the plain version, a bit-identical rerun, and five numbers: `ms`
     (CUDA events around the Python call, median of 50), `device_ms` (the
     kernel's own device time per call, torch.profiler over 50 calls),
     `plain_ms`, `library_ms` (one PyTorch call: torch.mm(Uᵀ, [U | Z]) for
     factor_prep, torch.linalg.cholesky_ex(I + G/vₙ) for nll_core) and
     `bound_ms` (the larger of FLOP over 67 TFLOP/s and bytes over
     3.35 TB/s, counting what the function needs: G's lower triangle, as G
     is symmetric);
  4. the slice at the full width of BASELINE's GPPVAE-joint: synthetic
     rotated digits (P = 400, Q = 16, 32×32×1), train_vae for 1 epoch, then
     train_gppvae --mode joint for 3 epochs from its vae_weights, both
     through their `main(argv)`; checks finite metrics, a falling loss, the
     kernels' launch counts, no plain-version call on a CUDA tensor, and the
     final GP NLL on the card against a float64 CPU evaluation;
  5. (a) the headline (bench.py config 3b): the same slice with --dtype
     bfloat16 --dec_upsample subpixel, and --polish_epochs 1 for the joint
     run; checks that both Adams restarted at the float32 switch and the
     bf16 latents against the same weights in f32;
     (b) the GP options at face-view 128² (config 4 widths): rbf object
     kernel (32 RFF features), an extra object effect, learn_sigma_y,
     grad_accum_steps 2, refresh_every_steps 3, subpixel, 2 epochs (R = 232);
     checks the launch count per refresh, the final GP NLL against CPU
     float64, and both kernels on the trained inputs;
     (c) rbf-nystrom on the digits, 1 epoch;
     (d) the digits at R = 560 (rbf, 80 RFF features), past the TPU
     kernel's 512, 1 joint epoch: one launch of each kernel and the final GP
     NLL against CPU float64;
  6. the `kernels` line (each kernel at the main path's shape, launches
     summed over the paths), then the last line: {"ok": true, "device": ...}.

Every path (4, 5a-d) sets the kernels' counts to 0 just before it and reads
them just after.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# (N, R, L); the first of each is the main path's (phase 4), (332, 232, 32)
# path (b)'s, (5700, 560, 16) path (d)'s; from R = 560 past the TPU kernel's 512
SHAPES_FACTOR_PREP = [(5700, 56, 16), (5701, 56, 16), (6401, 256, 16), (256, 2048, 8),
                      (332, 232, 32), (5700, 560, 16)]
SHAPES_NLL_CORE = [(5700, 56, 16), (332, 232, 32), (5700, 560, 16), (6400, 600, 16),
                   (6400, 1024, 16), (6400, 2048, 8)]
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
KERNEL_KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_method", "plain_ms", "bound_ms",
               "bound_by", "library_ms")
FACTOR_PREP_REL_BOUND = 1e-5  # max abs err / max |plain|, fp32 sums of N terms
NLL_VALUE_REL_BOUND = 1e-5
NLL_GRAD_REL_BOUND = 1e-4  # per gradient, err / max |plain grad|
SLICE_NLL_REL_BOUND = 1e-4  # card (fp32, kernels) vs CPU float64, N = 5700
# bf16 vs f32 latents of the same trained weights, max abs err / max |Z|:
# 4.8e-3 measured on an H100; the CPU bound of bf16 against flax's bf16
LATENT_BF16_REL_BOUND = 2e-2
SLICE_ARGS = ["--data", "synthetic", "--num_objects", "400", "--num_views", "16",
              "--seed", "0", "--device", "cuda"]
HEADLINE = ["--dtype", "bfloat16", "--dec_upsample", "subpixel"]
FACES_ARGS = ["--data", "faces", "--num_objects", "50", "--num_views", "8",
              "--image_size", "128", "--zdim", "32", "--bs", "64", "--seed", "0",
              "--device", "cuda", "--dec_upsample", "subpixel", "--object_kernel", "rbf",
              "--rff_features", "32", "--extra_effects", "object", "--learn_sigma_y",
              "--grad_accum_steps", "2", "--refresh_every_steps", "3"]


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 50) -> float:
    """Median milliseconds of one call, between CUDA events on the stream."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) over paired tensors."""
    err = max(float((g - w).detach().abs().max()) for g, w in zip(got, want))
    scale = max(float(w.detach().abs().max()) for w in want)
    return err, err / max(scale, 1e-30)


def phase_environment() -> str:
    say("== 1 environment")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    say(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from gppvae_tpu_torch.ops import _build

    say("== 2 build")
    t0 = time.perf_counter()
    _build.load()
    say(f"built {_build.SOURCES} for sm_90a in {time.perf_counter() - t0:.2f} s")
    for line in _build.nvcc_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("  " + line.strip())


def device_ms(fn, reps: int = 50) -> tuple[float, str]:
    """The kernel's own device time per call: its CUDA kernels' time summed
    in torch.profiler's key_averages() over `reps` calls, over reps. If the
    profiler shows no device time, CUDA events around `reps` back-to-back
    calls instead (which then include any launch gaps). Returns (ms, method)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation)
    if us > 0:
        return us / 1e3 / reps, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events"


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): FLOP over the fp32
    peak outside the tensor cores, bytes (each input read once, each output
    written once) over the memory rate."""
    t_op, t_mem = flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def timings(kernel, plain, library, flop: float, nbytes: float) -> dict:
    """The five numbers of one kernel at one shape; the event timings come
    first, so that no profiler session of this shape precedes them."""
    b_ms, b_by = bound(flop, nbytes)
    t = {"ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library)}
    d_ms, method = device_ms(kernel)
    return {**t, "device_ms": d_ms, "device_ms_method": method, "bound_ms": b_ms,
            "bound_by": b_by}


def say_timings(label: str, t: dict) -> None:
    say(f"  {label}: ms {t['ms']:.4f}, device_ms {t['device_ms']:.4f} ({t['device_ms_method']}), "
        f"plain_ms {t['plain_ms']:.4f}, library_ms {t['library_ms']:.4f}, "
        f"bound_ms {t['bound_ms']:.6f} ({t['bound_by']})")


def check_factor_prep(gen, n: int, r: int, l: int) -> dict:
    """factor_prep at (N, R, L): values, gradients and a rerun against the
    plain version, then the five timings. The library call is one cuBLAS
    GEMM giving [G | UᵀZ] (‖Z‖² left out)."""
    from gppvae_tpu_torch import ops

    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    got = ops.launch_factor_prep(U, Z)
    want = ops.factor_prep_torch(U, Z)
    again = ops.launch_factor_prep(U, Z)
    torch.cuda.synchronize()
    err, rel = max_err(got, want)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    A = torch.randn(r, r, device="cuda", generator=gen)
    B = torch.randn(r, l, device="cuda", generator=gen)

    def loss(fn, U, Z):
        G, UtZ, zn = fn(U, Z)
        return torch.sum(G * A) + torch.sum(UtZ * B) + 3.0 * zn

    U1, Z1 = U.clone().requires_grad_(), Z.clone().requires_grad_()
    g_k = torch.autograd.grad(loss(ops.factor_prep, U1, Z1), (U1, Z1))
    U2, Z2 = U.clone().requires_grad_(), Z.clone().requires_grad_()
    g_p = torch.autograd.grad(loss(ops.factor_prep_torch, U2, Z2), (U2, Z2))
    torch.cuda.synchronize()
    gerr, grel = max_err(g_k, g_p)
    say(f"factor_prep N={n} R={r} L={l}: max abs err {err:.3e}, rel {rel:.3e}; grads rel "
        f"{grel:.3e} (bound {FACTOR_PREP_REL_BOUND:.0e}); zn shape {tuple(got[2].shape)}; "
        f"bit-identical rerun {same}")
    check(rel <= FACTOR_PREP_REL_BOUND, f"factor_prep {n, r, l} error")
    check(grel <= FACTOR_PREP_REL_BOUND, f"factor_prep {n, r, l} gradients")
    check(got[2].dim() == 0, "factor_prep zn is 0-d")
    check(same, f"factor_prep {n, r, l} is deterministic")
    UZ = torch.cat([U, Z], 1)
    t = timings(lambda: ops.launch_factor_prep(U, Z), lambda: ops.factor_prep_torch(U, Z),
                lambda: torch.mm(U.T, UZ), flop=n * r * (r + 1) + 2.0 * n * r * l,
                nbytes=4.0 * (n * (r + l) + r * (r + l) + 1))
    say_timings(f"factor_prep N={n} R={r} L={l}", t)
    return {"shape": [n, r, l], "max_abs_err": err, **t}


def check_nll_core(gen, n: int, r: int, l: int) -> dict:
    """nll_core at R (G, UᵀZ from N rows): value and gradients through the
    autograd.Function against autograd of the plain version, a rerun, then
    the five timings. The library call is cuSOLVER's Cholesky of
    B = I + G/vₙ, the function's largest part (no sync on `info`)."""
    from gppvae_tpu_torch import ops

    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    G, UtZ, zn = ops.factor_prep_torch(U, Z)
    vn = torch.tensor(0.37, device="cuda")
    leaves_k = [t.clone().requires_grad_() for t in (G, UtZ, zn, vn)]
    nll_k = ops.woodbury_nll_core(*leaves_k, n, l)
    g_k = torch.autograd.grad(nll_k, leaves_k)
    leaves_p = [t.clone().requires_grad_() for t in (G, UtZ, zn, vn)]
    nll_p = ops.woodbury_nll_core_torch(*leaves_p, n, l)
    g_p = torch.autograd.grad(nll_p, leaves_p)
    k_out = ops.launch_nll_core(G, UtZ, zn, vn, n, l)
    again = ops.launch_nll_core(G, UtZ, zn, vn, n, l)
    p_out = ops.nll_core_torch(G, UtZ, zn, vn, n, l)
    torch.cuda.synchronize()
    verr, vrel = max_err([nll_k], [nll_p])
    rerr, _ = max_err(k_out[1:], p_out[1:])
    same = all(torch.equal(a, b) for a, b in zip(k_out, again))
    say(f"nll_core R={r} L={l}: nll {nll_k.item():.6f} vs {nll_p.item():.6f}, rel {vrel:.3e} "
        f"(bound {NLL_VALUE_REL_BOUND:.0e}); X, W max abs err {rerr:.3e}; "
        f"bit-identical rerun {same}")
    check(vrel <= NLL_VALUE_REL_BOUND, f"nll_core R={r} value")
    check(same, f"nll_core R={r} is deterministic")
    for name, a, b in zip(("G", "UtZ", "zn", "vn"), g_k, g_p):
        gerr, grel = max_err([a], [b])
        say(f"  d/d{name}: max abs err {gerr:.3e}, rel {grel:.3e} "
            f"(bound {NLL_GRAD_REL_BOUND:.0e})")
        check(grel <= NLL_GRAD_REL_BOUND, f"nll_core R={r} gradient {name}")
    B = torch.eye(r, device="cuda") + G / vn
    t = timings(lambda: ops.launch_nll_core(G, UtZ, zn, vn, n, l),
                lambda: ops.nll_core_torch(G, UtZ, zn, vn, n, l),
                lambda: torch.linalg.cholesky_ex(B), flop=2.0 * r**3 / 3 + r * r * l,
                nbytes=4.0 * (r * (r + 1) / 2 + r * r + 2 * r * l + 3))
    say_timings(f"nll_core R={r} L={l}", t)
    return {"shape": [n, r, l], "max_abs_err": verr, **t}


def phase_kernels() -> dict:
    say("== 3 kernel vs plain, and the yardsticks (ms: CUDA events around the Python "
        "call, median of 50; device_ms: the kernel's own device time per call)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {
        "factor_prep": [check_factor_prep(gen, *s) for s in SHAPES_FACTOR_PREP],
        "woodbury_nll_core": [check_nll_core(gen, *s) for s in SHAPES_NLL_CORE],
    }


def drive(label: str, fn):
    """Run one path with the kernels' counts set to 0 just before it and
    read just after; checks that no plain version ran on a CUDA tensor.
    Returns (fn's result, counts)."""
    from gppvae_tpu_torch import ops

    ops.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    say(f"{label}: launch counts {counts}")
    check(counts["factor_prep_torch.cuda_calls"] == 0
          and counts["nll_core_torch.cuda_calls"] == 0,
          f"{label}: no plain version ran on a CUDA tensor")
    return result, counts


def report(hist) -> None:
    for h in hist:
        phases = " ".join(f"{k} {v:.5f}" for k, v in h.items()
                          if k.startswith("sec_") and k != "sec_epoch")
        say(f"epoch {h['epoch']}: loss {h['loss']:.4f} gp_nll_full {h['gp_nll_full']:.6f} "
            f"oos_mse {h['oos_mse']:.6f} sec_epoch {h['sec_epoch']:.4f} ({phases})")
    check(all(math.isfinite(v) for h in hist for k, v in h.items()
              if isinstance(v, float)), "every metric is finite")


def final_nll_check(result, label: str) -> tuple:
    """The trained model's exact GP NLL on the rows it trained on: kernels
    on the card vs CPU float64. Returns (Z, Vs, v_sigs, v_noise)."""
    from gppvae_tpu_torch import gp
    from gppvae_tpu_torch.models import encode_all

    data, p, cfg = result.data, result.gp_params, result.config
    W = p["W"] if "W" in p else result.fixed_W
    with torch.no_grad():
        Z = encode_all(result.model, data["images_tr"], 1024)
        Vs = gp.build_effect_rows(p["X"], W, data["d_tr"], data["q_tr"],
                                  extra_effects=cfg.extra_effects, x_map=result.x_map)
        v_sig, v_noise = gp.variances_from_log(p["log_vs"], p["log_vn"])
        v_sigs = [v_sig[i] for i in range(len(Vs))]
        nll_card = float(gp.gp_nll_from_features(Z, Vs, v_sigs, v_noise))
        nll_cpu = float(gp.gp_nll_from_features(
            Z.cpu().double(), [v.cpu().double() for v in Vs],
            [v.cpu().double() for v in v_sigs], v_noise.cpu().double()))
    rel = abs(nll_card - nll_cpu) / abs(nll_cpu)
    say(f"{label} final GP NLL: card (kernels, f32) {nll_card:.4f}, CPU f64 {nll_cpu:.4f}, "
        f"rel {rel:.3e} (bound {SLICE_NLL_REL_BOUND:.0e}); Z {tuple(Z.shape)}, "
        f"R = {sum(v.shape[1] for v in Vs)}")
    check(rel <= SLICE_NLL_REL_BOUND, f"{label}: final GP NLL agrees with CPU float64")
    check(bool(torch.isfinite(Z).all()), f"{label}: latents finite")
    return Z, Vs, v_sigs, v_noise


def phase_slice() -> dict:
    from gppvae_tpu_torch.train import train_gppvae, train_vae

    say("== 4 slice: train_vae 1 epoch → train_gppvae --mode joint 3 epochs "
        "(P=400, Q=16, zdim 16, R=56, bs 128, f32)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        def run():
            train_vae.main([*SLICE_ARGS, "--epochs", "1", "--outdir", f"{tmp}/vae"])
            return train_gppvae.main([
                *SLICE_ARGS, "--mode", "joint", "--epochs", "3",
                "--vae_weights", f"{tmp}/vae/{train_vae.WEIGHTS_FILE}",
                "--outdir", f"{tmp}/gppvae",
            ])

        result, counts = drive("4 slice", run)
    hist = result.history
    report(hist)
    check(hist[-1]["loss"] < hist[0]["loss"], "loss falls from the first epoch to the last")
    check(counts["launch_factor_prep.launches"] == 3, "factor_prep launched once per epoch")
    check(counts["launch_nll_core.launches"] == 3, "nll_core launched once per epoch")
    Z, *_ = final_nll_check(result, "4 slice")
    check(Z.shape == (5700, 16), "latents (5700, 16)")
    return counts


def path_headline() -> dict:
    from gppvae_tpu_torch.models import encode_all
    from gppvae_tpu_torch.train import train_gppvae, train_vae

    say("== 5a headline (config 3b): bf16 + subpixel, train_vae 1 epoch → "
        "train_gppvae --mode joint 3 epochs, the last in f32 (--polish_epochs 1)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        def run():
            train_vae.main([*SLICE_ARGS, *HEADLINE, "--epochs", "1", "--outdir", f"{tmp}/vae"])
            return train_gppvae.main([
                *SLICE_ARGS, *HEADLINE, "--mode", "joint", "--epochs", "3",
                "--polish_epochs", "1",
                "--vae_weights", f"{tmp}/vae/{train_vae.WEIGHTS_FILE}",
                "--outdir", f"{tmp}/gppvae",
            ])

        result, counts = drive("5a headline", run)
    hist = result.history
    report(hist)
    check(hist[-1]["loss"] < hist[0]["loss"], "loss falls from the first epoch to the last")
    check(counts["launch_factor_prep.launches"] == 3 and counts["launch_nll_core.launches"] == 3,
          "each kernel launched once per epoch")
    opts = result.optimizers
    nb = -(-result.data["images_tr"].shape[0] // result.config.batch_size)
    say(f"Adam steps after the switch: vae {opts['vae'].steps}, gp {opts['gp'].steps} "
        f"(one f32 epoch = {nb} steps; no restart would give {3 * nb})")
    check(opts["vae"].steps == opts["gp"].steps == nb, "both Adams restarted at the f32 switch")
    check(result.model.dtype == torch.float32, "the polish tail runs float32")
    final_nll_check(result, "5a headline")
    images = result.data["images_tr"]
    result.model.dtype = torch.bfloat16
    Z_bf16 = encode_all(result.model, images, 1024)
    result.model.dtype = torch.float32
    Z_f32 = encode_all(result.model, images, 1024)
    rel = float((Z_bf16 - Z_f32).abs().max()) / float(Z_f32.abs().max())
    say(f"latents of the trained weights, bf16 vs f32 compute: max abs err / max |Z| "
        f"{rel:.3e} (bound {LATENT_BF16_REL_BOUND:.0e}); dtype {Z_bf16.dtype}")
    check(Z_bf16.dtype == torch.float32 and rel <= LATENT_BF16_REL_BOUND,
          "bf16 latents agree with f32 latents of the same weights")
    return counts


def path_faces() -> dict:
    from gppvae_tpu_torch import ops
    from gppvae_tpu_torch.train import train_gppvae

    say("== 5b GP options at face-view 128² (config 4 widths): rbf (32 RFF) + object "
        "effect, learn_sigma_y, grad_accum 2, refresh every 3 steps, subpixel, 2 epochs")
    epochs, refresh = 2, 3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        result, counts = drive("5b faces", lambda: train_gppvae.main([
            *FACES_ARGS, "--mode", "joint", "--epochs", str(epochs), "--outdir", f"{tmp}/g"]))
    hist = result.history
    report(hist)
    nb = -(-result.data["images_tr"].shape[0] // result.config.batch_size)
    launches = epochs * -(-nb // refresh)  # epochs × (1 + refreshes per epoch)
    check(counts["launch_factor_prep.launches"] == launches
          and counts["launch_nll_core.launches"] == launches,
          f"each kernel launched {launches} times (epochs × (1 + refreshes))")
    check("log_sy" in result.gp_params and result.gp_params["log_vs"].shape == (2,),
          "sigma_y learned, two signal variances")
    Z, Vs, v_sigs, v_noise = final_nll_check(result, "5b faces")
    R = sum(v.shape[1] for v in Vs)
    check(R == 232, "R = 32·7 + 8 = 232")

    # both kernels on this path's trained inputs, against their plain versions
    U = torch.cat([torch.sqrt(s) * v for s, v in zip(v_sigs, Vs)], dim=1).contiguous()
    got, want = ops.launch_factor_prep(U, Z), ops.factor_prep_torch(U, Z)
    err, rel = max_err(got, want)
    check(rel <= FACTOR_PREP_REL_BOUND, "factor_prep at R = 232")
    G, UtZ, zn = want
    n, L = Z.shape
    k_out = ops.launch_nll_core(G, UtZ, zn, v_noise, n, L)
    p_out = ops.nll_core_torch(G, UtZ, zn, v_noise, n, L)
    verr, vrel = max_err(k_out[:1], p_out[:1])
    check(vrel <= NLL_VALUE_REL_BOUND, "nll_core at R = 232")
    say(f"trained inputs at N={n}, R={R}, L={L}: factor_prep rel {rel:.3e}, "
        f"nll_core rel {vrel:.3e}")
    return counts


def path_nystrom() -> dict:
    from gppvae_tpu_torch.train import train_gppvae

    say("== 5c rbf-nystrom on the digits: 16 landmarks (R = 112), 1 epoch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        result, counts = drive("5c nystrom", lambda: train_gppvae.main([
            *SLICE_ARGS, "--mode", "joint", "--epochs", "1", "--object_kernel", "rbf-nystrom",
            "--nystrom_rank", "16", "--outdir", f"{tmp}/g"]))
    report(result.history)
    check(counts["launch_factor_prep.launches"] == 1 and counts["launch_nll_core.launches"] == 1,
          "each kernel launched once")
    _, Vs, _, _ = final_nll_check(result, "5c nystrom")
    check(Vs[0].shape[1] == 112, "R = 16·7 = 112")
    return counts


def path_large_rank() -> dict:
    from gppvae_tpu_torch.train import train_gppvae

    say("== 5d the digits at R = 560 (rbf, 80 RFF features × 7 view features), past the "
        "TPU kernel's 512: 1 joint epoch from a fresh VAE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        result, counts = drive("5d R=560", lambda: train_gppvae.main([
            *SLICE_ARGS, "--mode", "joint", "--epochs", "1", "--object_kernel", "rbf",
            "--rff_features", "80", "--outdir", f"{tmp}/g"]))
    report(result.history)
    check(counts["launch_factor_prep.launches"] == 1 and counts["launch_nll_core.launches"] == 1,
          "each kernel launched once")
    _, Vs, _, _ = final_nll_check(result, "5d R=560")
    check(Vs[0].shape[1] == 560, "R = 80·7 = 560")
    return counts


def main() -> None:
    kind = phase_environment()
    phase_build()
    stats = phase_kernels()
    paths = [phase_slice(), path_headline(), path_faces(), path_nystrom(), path_large_rank()]
    sources = {
        "factor_prep": ("gppvae_tpu_torch/csrc/factor_prep.cu",
                        "gppvae_tpu/ops/pallas_gemm.py:162", "launch_factor_prep.launches"),
        "woodbury_nll_core": ("gppvae_tpu_torch/csrc/nll_core.cu",
                              "gppvae_tpu/ops/pallas_chol.py:167", "launch_nll_core.launches"),
    }
    kernels = []
    for name, (src, rep, key) in sources.items():
        per_path = [c[key] for c in paths]
        check(all(per_path), f"{name} launched in every path: {per_path}")
        main_shape = stats[name][0]  # the main path's (phase 4)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(per_path),
                        **{k: main_shape[k] for k in KERNEL_KEYS}})
    for name, rows in stats.items():
        say(f"{name} at every shape: " + json.dumps(
            [{"shape": row["shape"], **{k: row[k] for k in KERNEL_KEYS}} for row in rows]))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
