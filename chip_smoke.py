#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one per printed line group; any failure ends the run non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit,
     the TF32 flags. Raises without CUDA;
  2. build: the CUDA kernels from gppvae_tpu_torch/csrc with nvcc for
     sm_90a, one nvcc per source, started together;
  3. kernel vs plain on the card: the factor_prep kernels' registers and
     spills (nvcc.log) and their tensor-core products (HMMA…TF32 in
     cuobjdump -sass: above 0, no spills); factor_prep at (N, R, L) =
     (5700,56,16), (5701,56,16), (6401,256,16), (256,2048,8), (332,232,32),
     (5700,560,16), (2850,56,16), tools/kernel_ab.py's (262144,256,16), a
     ragged R across the tensor-core tiles (57, 130), L = 1 and N shorter
     than one stage (20);
     nll_core at R = 56, 232, 560, 600, 1024, 2048 (L 16, 32, 16, 16, 16, 8),
     a ragged R in each driver's band (233, 561, 1000) and, at L = 16, R on
     either side of and at each cut-over between its drivers that the plan
     chose on this card (ops.nll_core.plan_nll_core): every driver launched
     at least once, each shape's driver printed. At each shape the
     value and the gradients through the autograd.Function against autograd
     of the plain version (factor_prep: G, UᵀZ, ‖Z‖², dU and dZ each
     against its own max |plain|), a bit-identical rerun (and G exactly
     symmetric), and five numbers: `ms` (CUDA events around the Python
     call, median of 50), `device_ms` (the call's device time: CUDA events
     around 50 calls queued behind torch.cuda._sleep, so the host's enqueue
     is hidden; where that reading is above `ms`, torch.profiler's kernel
     time instead; and `host_ms`, ms − device_ms),
     `plain_ms`, `library_ms` (one PyTorch call: torch.mm(Uᵀ, [U | Z]) for
     factor_prep, torch.linalg.cholesky_ex(I + G/vₙ) for nll_core) and
     `bound_ms` (the larger of FLOP over 165 TFLOP/s, float32-accurate
     products on the tensor cores in split TF32, a third of the TF32 peak,
     and bytes over 3.35 TB/s, counting what the function needs: G's lower
     triangle, as G is symmetric); conv3x3 at every kind of layer the main
     paths run (SHAPES_CONV3X3, batch 64 or 128): y, dX, dW, db against
     float64 and a bit-identical rerun, then the five numbers of fprop,
     dgrad, wgrad and the whole backward, each through the calls a training
     step makes (library: cuDNN's float32 F.conv2d and its backward, which
     the port no longer calls);
  4. the slice at the full width of BASELINE's GPPVAE-joint: synthetic
     rotated digits (P = 400, Q = 16, 32×32×1), train_vae for 1 epoch, then
     train_gppvae --mode joint for 3 epochs from its vae_weights, both
     through their `main(argv)`; prints the analytic FLOP per epoch
     (utils/flops.py) and the rate achieved against the fp32 peak (also in
     5a); checks finite metrics, a falling loss, the
     kernels' launch counts, no plain-version call on a CUDA tensor, and the
     final GP NLL on the card against a float64 CPU evaluation;
  5. (a) the headline (bench.py config 3b): the same slice with --dtype
     bfloat16 --dec_upsample subpixel, and --polish_epochs 1 for the joint
     run; checks that both Adams restarted at the float32 switch, the
     bf16 latents against the same weights in f32, and the trained
     decoder in bf16 (`check_decoder_bf16`): that its forward ran the
     merged lowering (each upsampling stage one `_upconv`, a transposed
     conv, no nearest upsample), each stage's merged kernel bit for bit
     and its output against the merged function in float64 on the CPU;
     (b) the GP options at face-view 128² (config 4 widths): rbf object
     kernel (32 RFF features), an extra object effect, learn_sigma_y,
     grad_accum_steps 2, refresh_every_steps 3, subpixel, 2 epochs (R = 232);
     checks the launch count per refresh, the final GP NLL against CPU
     float64, and both kernels on the trained inputs;
     (c) rbf-nystrom on the digits, 1 epoch;
     (d) the digits at R = 560 (rbf, 80 RFF features), past the TPU
     kernel's 512, 1 joint epoch: one launch of each kernel (nll_core by
     the driver its plan picks, printed) and the final GP NLL against CPU
     float64;
  6. serving, from the runs of 4, 5a and 5b (their directories are kept):
     `generate` (held-out MSE = the trainer's last oos_mse, float32 runs),
     `generate --export_server`, then `serve --state` through each main(argv):
     --requests over the held-out cells with --var (= generate's images),
     --observe (no observed cell's variance rises; two observes = one over
     both batches), --sample 4 --joint, the --stdin loop, and --repeat 20
     --sustained 20 at a 200-image batch (bench.py:320-346's protocol); every
     state tensor on cuda, and neither kernel launched: the serving path has
     none (the JAX package's gram and matmul_tn have no Pallas kernel). Prints
     fold_s (build_server_state alone), the observe fold_s, latency_s and
     the two rates per run. Then the exported program of each run: `serve
     --state m.srv --export_exe m.exe` (each entry's export seconds and
     bytes), and `serve --exe m.exe` for the same requests with --var,
     --sample 4 and --sample 4 --joint at one seed, --observe --save_core
     then --core, the --stdin loop on the same lines, and --repeat 20
     --sustained 20: every reply within a stated bound of the `serve --state`
     reply, the rates side by side, still no kernel launch;
  7. resume at the slice's width: --dtype bfloat16 --polish_epochs 2, 4
     epochs with --checkpoint_every 1 --panel_every 1, then the same run
     resumed from state_0002 (the float32 switch: both Adams restart) and
     from state_0003 (inside the window: they do not); every history key
     agrees with the uninterrupted run (rtol 1e-4), the panels and states
     are on disk, each kernel is launched once per epoch actually run, and
     a 1-epoch run with --profile_dir leaves a Chrome trace with CUDA
     kernel events;
  8. the accuracy protocol, validate_torch.run_validation(device="cuda") at
     its own depth (60 pretrain + 150 epochs; 180 real digits × 16 views,
     32², zdim 16, the published encoder and decoder, bs 128): the two
     trivial baselines against the JAX package's recorded values (1e-6),
     verdict PASS, the ordering joint, dis < LIVAE < per-view-mean < CVAE <
     train-mean, no kernel launch in the VAE, LIVAE and CVAE stages and one
     of each kernel per epoch in dis and joint; then train-cvae for 2
     epochs at the same width through its main(argv);
  9. data parallelism (gppvae_tpu_torch/parallel/): one RankPool of 2 gloo
     ranks, both on cuda:0 (NCCL takes one rank per card; gloo all-reduces
     CUDA tensors, and only all_reduce and broadcast are used), running
     functions of parallel/dryrun.py. (a) GPPVAE-joint at the slice's width
     (P = 400 × Q = 16, 5,700 rows, zdim 16, R = 56, f32, bs 128, from path
     4's vae_weights), 2 epochs on 2 ranks against the same run in one
     process, run twice: every history key within max(1e-4, 10 × the two
     single runs' spread); each rank launches each kernel once per epoch
     (factor_prep on its 2,850 rows) and no plain version on a CUDA tensor;
     the collectives of each epoch (calls, bytes, the largest), none larger
     than the gradient all-reduce; sec/epoch beside one process's; then
     parallel.dryrun on the same ranks (the small config, and the same
     collectives at 53 and 56 training rows); (b) train_vae, 1 epoch at the
     same width, on 2 ranks against one process (twice); (c) the data-
     parallel fold, predict_images (with variances) and observe of (a)'s
     trained params against the single-process serving calls, max abs err /
     max |·| ≤ 1e-5;
 10. tensor parallelism (parallel/tensor.py): one RankPool of 4 gloo ranks
     on cuda:0 as a 2 × 2 data × model mesh. (a) GPPVAE-joint as 9a (the
     slice's width, 2 epochs from path 4's vae_weights) at the default
     threshold, so that seven weights split over the model axis, held to
     path 9's two single-process runs (not trained again) within the same
     bound; one digest of the whole parameters on every rank, each rank's
     blocks its rows of them; each rank launches each kernel once per epoch
     and no plain version on a CUDA tensor; each epoch's collectives per axis
     (calls, bytes, the largest) and sec/epoch with its phases beside one
     process's; the split weights and their blocks' shapes; (c) parallel.
     dryrun(4) on the same ranks, the 2-D branch; (d) a split conv in
     bfloat16 against the unsplit one on the card (gloo's all-reduce of
     bfloat16 CUDA tensors);
 12. the JAX package's random stream (utils/prng.py), which every trainer,
     generate and serve draw from: split(PRNGKey(0), 4) and flax's init of
     the VAE at the published widths from its init key held to constants
     that jax.random gave (PRNG_GOLDEN; tests/test_torch_prng.py holds them
     to jax on the CPU), then train_vae 1 epoch → train_gppvae --mode joint
     2 epochs at seed 0 on the slice's grid through their main(argv): epoch
     0's plan (the permutation of 5,700 rows) and all 45 steps' ε as the
     trainer drew them equal the constants, one launch of each kernel per
     epoch, finite metrics;
 13. the `kernels` line (each kernel at the main path's shape, launches
     summed over the training paths 4, 5a-d, 7, 8, 9a's and 10a's ranks,
     12), then the last line: {"ok": true, "device": ...}.

Every path (4, 5a-d, 6 per run, each run of 7, 8, 12) sets the kernels' counts
to 0 just before it and reads them just after; in paths 9 and 10 each rank
does so around its own run (parallel/dryrun.py), and its counts come back
with it.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import math
import statistics
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gppvae_tpu_torch.utils.kernel_timing import (
    FACTOR_PREP_REL_BOUND,
    FP32_FLOPS,
    NLL_GRAD_REL_BOUND,
    NLL_VALUE_REL_BOUND,
    max_err,
    max_rel_err,
    time_factor_prep,
    time_conv3x3,
    timings,
)

# (N, R, L); the first of each is the main path's (phase 4), (332, 232, 32)
# path (b)'s, (5700, 560, 16) path (d)'s, (2850, 56, 16) one rank's shard in
# path 9; from R = 560 past the TPU kernel's 512. factor_prep then:
# tools/kernel_ab.py's N 262,144 at R 256, R across the tensor-core tiles (57
# and 130, also the 4-byte copies), L = 1, and N shorter than one 32-row stage
SHAPES_FACTOR_PREP = [(5700, 56, 16), (5701, 56, 16), (6401, 256, 16), (256, 2048, 8),
                      (332, 232, 32), (5700, 560, 16), (2850, 56, 16), (262144, 256, 16),
                      (5700, 57, 16), (5700, 130, 16), (5700, 56, 1), (20, 56, 16)]
# nll_core: then a ragged R in the cluster's band and past it; nll_core_shapes()
# adds R at and beside each cut-over between the drivers
SHAPES_NLL_CORE = [(5700, 56, 16), (332, 232, 32), (5700, 560, 16), (6400, 600, 16),
                   (6400, 1024, 16), (6400, 2048, 8), (6400, 233, 16), (6400, 561, 16),
                   (6400, 1000, 16)]
# conv3x3 (batch, H, W, Cin, Cout, stride, pads, ELU): FaceVAE's 32 → 32 at
# 64² and 128² (stride 1; 128² → 64² at stride 2) and its first, 3 → 32 at
# 128²; its last stage, 32 → 3 (the swapped weight gradient) and 3 → 3,
# linear; the faces layout's 'SAME' (0, 1) stride 2 at 3 → 32 and 32 → 32;
# the digits' 64 → 128 (the channel tile cut, N in tiles)
PAD1, SAME = (1, 1, 1, 1), (0, 1, 0, 1)
SHAPES_CONV3X3 = [(64, 64, 64, 32, 32, 1, PAD1, True), (64, 128, 128, 32, 32, 1, PAD1, True),
                  (64, 128, 128, 32, 32, 2, PAD1, True), (64, 128, 128, 3, 32, 1, PAD1, True),
                  (64, 128, 128, 32, 3, 1, PAD1, True), (64, 128, 128, 3, 3, 1, PAD1, False),
                  (64, 128, 128, 3, 32, 2, SAME, True), (64, 64, 64, 32, 32, 2, SAME, True),
                  (128, 8, 8, 64, 128, 2, SAME, True)]
CONV3X3_REL_BOUND = 2e-6  # each pass, max abs err / max |float64|
KERNEL_KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_method", "plain_ms", "bound_ms",
               "bound_by", "library_ms")
SLICE_NLL_REL_BOUND = 1e-4  # card (fp32, kernels) vs CPU float64, N = 5700
# bf16 vs f32 latents of the same trained weights, max abs err / max |Z|:
# 4.8e-3 measured on an H100; the CPU bound of bf16 against flax's bf16
LATENT_BF16_REL_BOUND = 2e-2
# 5a: each upsampling stage of the trained decoder in bfloat16 (the card's own
# input to the stage) against the merged function in float64 on the CPU: the
# 4×4 kernel merged from the bf16 weight, each tap sum rounded to bf16, the
# conv over the input dilated by 2, rounded to bf16, then + the bf16 bias,
# rounded. The two differ only where the card's float32 sums cross a bf16
# rounding boundary that the float64 sums do not, by one bf16 ulp: max abs err
# / max |ref| at most one ulp of the largest value (2⁻⁷ of it), and at most
# this share of the outputs off. Measured on the CPU at the published widths
# (digits 32², faces 128²): the merged stage 0.001-0.003 % of outputs off,
# max 0.95e-3-2.5e-3; the resize forward 53-55 % off, max 3.8e-3-6.4e-3
DECODER_STAGE_REL_BOUND = 2.0**-7
DECODER_STAGE_DIFFER_BOUND = 0.05
DECODER_CHECK_ROWS = 256
SLICE_ARGS = ["--data", "synthetic", "--num_objects", "400", "--num_views", "16",
              "--seed", "0", "--device", "cuda"]
HEADLINE = ["--dtype", "bfloat16", "--dec_upsample", "subpixel"]
DIGITS_DATA = ("synthetic", 400, 16, 0)  # build_dataset_from_flag(flag, P, Q, seed)
FACES_DATA = ("faces", 50, 8, 0, 128)
# path 6 (serving): bench.py:320-346's protocol, 20 rotated 200-image batches
SERVE_BATCH, SERVE_CHAIN, SERVE_REPEAT = 200, 20, 20
ARCH_KEYS = ("zdim", "enc_features", "dec_features", "object_kernel", "rff_lengthscale",
             "extra_effects", "dec_upsample", "compute_dtype")
HELDOUT_MSE_REL_BOUND = 1e-5  # generate vs the trainer's last oos_mse: one f32 computation
SERVE_IMAGE_ABS_BOUND = 1e-5  # serve vs generate_heldout: the same fold, card and dtype
VAR_SLACK_REL = 1e-5  # observe: variance after ≤ before × (1 + this), f32 rounding
OBSERVE_SPLIT_REL_BOUND = 1e-4  # two observes vs one, max |Δ mean| / max |mean|, f32
# serve --exe vs serve --state: the exported graph runs the eager path's ATen
# ops in its order, on the same card and dtype
EXE_IMAGE_ABS_BOUND = 1e-5  # float32 runs: images in [0, 1], means and draws
# a bfloat16 run: a last-bit difference in the float32 latents (a batch of one
# may reach another BLAS routine) can flip one bfloat16 rounding in the
# decoder; one ulp of a value below 1 is 4e-3
EXE_IMAGE_ABS_BOUND_BF16 = 4e-3
EXE_VAR_ABS_BOUND = 2e-6  # the reply's posterior_var, printed to 6 decimals
EXE_CORE_REL_BOUND = 1e-4  # the observe-updated core, max |Δ| / max |·| per tensor
FACES_ARGS = ["--data", "faces", "--num_objects", "50", "--num_views", "8",
              "--image_size", "128", "--zdim", "32", "--bs", "64", "--seed", "0",
              "--device", "cuda", "--dec_upsample", "subpixel", "--object_kernel", "rbf",
              "--rff_features", "32", "--extra_effects", "object", "--learn_sigma_y",
              "--grad_accum_steps", "2", "--refresh_every_steps", "3"]


# path 7: the history keys a resumed run is held to, and the bound (float32
# epochs on the card; cuDNN's backward may sum in another order run to run)
RESUME_KEYS = ("loss", "recon_term", "gp_term", "pen_term", "gp_nll_full", "oos_mse")
RESUME_REL_BOUND = 1e-4
# path 8: the JAX package's recorded trivial baselines on the same dataset
# (functions of the data and the split alone), and the protocol's depth
BASELINE_TRAIN_MEAN, BASELINE_PER_VIEW_MEAN = 0.0625584, 0.0166757
BASELINE_ABS_BOUND = 1e-6
PROTOCOL_PRETRAIN, PROTOCOL_EPOCHS = 60, 150
PROTOCOL_ARGS = ["--data", "sklearn", "--num_objects", "180", "--num_views", "16",
                 "--seed", "0", "--device", "cuda"]
# path 9: the slice's grid and widths (the trainers' defaults: zdim 16, bs 128,
# encoder (32, 64, 128), xdim 8 × 7 view features = R 56), 2 ranks on one card
DP_WORLD, DP_DEVICE = 2, "cuda:0"
DP_DATA = dict(source="synthetic", num_objects=400, num_views=16, seed=0)
DP_GPPVAE = dict(mode="joint", epochs=2, seed=0)
DP_VAE = dict(epochs=1, seed=0)
# ranks vs one process: at least this, or 10× the spread of two single runs
DP_REL_FLOOR = 1e-4
DP_SERVE_REL_BOUND = 1e-5  # serving: max abs err / max |·|, fp32 sums in another order
# path 10: the 2 × 2 mesh on the same card, and the weights that split at the
# published widths (the JAX package's shard_params_model_axis splits the same)
TP_MESH = (2, 2)
TP_SPLIT = {"encoder.convs.1.weight", "encoder.convs.2.weight", "encoder.dense.weight",
            "decoder.dense.weight", "decoder.convs.0.weight", "decoder.convs.1.weight",
            "decoder.convs.2.weight"}
# a split bfloat16 conv against the unsplit one: max abs err / max |y|, a few
# bfloat16 ulps (2^-8 each) where the two convolutions round apart
TP_BF16_REL_BOUND = 2e-2
# path 12: what jax.random (jax 0.9.0: threefry2x32, partitionable, x64 off)
# gave on the CPU at seed 0: split(PRNGKey(0), 4) (run, init, sample, x
# keys), epoch 0's plan over the slice's 5,700 rows (its first entries and
# Σ i·perm[i]), its 45 steps' ε (the first values of step 0, Σε and Σε² in
# float64) and Σ|w| per weight of flax's VAE.init at the published widths
# from the init key. The card's machine has no jax; tests/test_torch_prng.py
# holds these to jax.random
STREAM_EPOCHS = 2
PRNG_GOLDEN = {
    "split": [[1797259609, 2579123966], [928981903, 3453687069],
              [4146024105, 2718843009], [2467461003, 3840466878]],
    "perm_head": [4982, 1891, 3918, 311, 121, 2639, 5348, 298],
    "perm_checksum": 46016636328,
    "eps_head": [0.03702253848314285, -1.410986304283142, -0.3259766399860382,
                 1.0439293384552002, 0.2575187087059021, 0.9758078455924988],
    "eps_sum": 147.09934907594788,
    "eps_sumsq": 91847.07441675411,
    "init_abs_sums": {
        "encoder.convs.0.weight": 78.13123009732226,
        "encoder.convs.1.weight": 891.7840479440152,
        "encoder.convs.2.weight": 2528.7881784483743,
        "encoder.dense.weight": 4760.670080592179,
        "encoder.head_logvar.weight": 147.22123758382895,
        "encoder.head_mu.weight": 152.66566330517526,
        "decoder.convs.0.weight": 3572.8817648552986,
        "decoder.convs.1.weight": 1787.3444842126014,
        "decoder.convs.2.weight": 634.8820464978451,
        "decoder.out.weight": 14.717867502942681,
        "decoder.dense.weight": 6717.694003274013,
    },
}
# Σ of float32 draws in float64: the same values summed in numpy's order
PRNG_SUM_REL_BOUND = 1e-12


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase_environment() -> tuple[str, str]:
    """(torch's device name, nvidia-smi's `name, power.limit` line)."""
    say("== 1 environment")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip() or smi.stderr.strip()
    say(f"nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return torch.cuda.get_device_name(0), card


def phase_build() -> None:
    from gppvae_tpu_torch.ops import _build

    say("== 2 build")
    t0 = time.perf_counter()
    _build.load()
    say(f"built {_build.SOURCES} for sm_90a in {time.perf_counter() - t0:.2f} s")
    for line in _build.nvcc_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("  " + line.strip())


def say_timings(label: str, t: dict) -> None:
    driver = f", driver {t['driver']}" if t["driver"] else ""
    dev, host = ("not resolved",) * 2 if t["device_ms"] is None else (
        f"{t['device_ms']:.4f}", f"{t['host_ms']:.4f}")
    say(f"  {label}: ms {t['ms']:.4f}, device_ms {dev} ({t['device_ms_method']}), "
        f"host_ms {host}, plain_ms {t['plain_ms']:.4f}, "
        f"library_ms {t['library_ms']:.4f}, bound_ms {t['bound_ms']:.6f} ({t['bound_by']})"
        + driver)


def check_factor_prep(gen, n: int, r: int, l: int) -> dict:
    """factor_prep at (N, R, L): values, gradients and a rerun against the
    plain version, then the five timings (kernel_timing.time_factor_prep)."""
    from gppvae_tpu_torch import ops

    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    got = ops.launch_factor_prep(U, Z)
    want = ops.factor_prep_torch(U, Z)
    again = ops.launch_factor_prep(U, Z)
    torch.cuda.synchronize()
    err = max_err(got, want)[0]
    rel = max_rel_err(got, want)  # each output against its own scale
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    symmetric = torch.equal(got[0], got[0].T)
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
    grel = max_rel_err(g_k, g_p)
    say(f"factor_prep N={n} R={r} L={l}: max abs err {err:.3e}, rel {rel:.3e}; grads rel "
        f"{grel:.3e} (bound {FACTOR_PREP_REL_BOUND:.0e}); zn shape {tuple(got[2].shape)}; "
        f"bit-identical rerun {same}; G symmetric {symmetric}")
    check(rel <= FACTOR_PREP_REL_BOUND, f"factor_prep {n, r, l} error")
    check(grel <= FACTOR_PREP_REL_BOUND, f"factor_prep {n, r, l} gradients")
    check(got[2].dim() == 0, "factor_prep zn is 0-d")
    check(same, f"factor_prep {n, r, l} is deterministic")
    check(symmetric, f"factor_prep {n, r, l}: G exactly symmetric")
    t = time_factor_prep(U, Z)
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


def check_conv3x3(gen, n: int, h: int, w: int, cin: int, cout: int, stride: int, pads,
                  elu: bool) -> list[dict]:
    """conv3x3 at one shape: y, dX, dW, db through ops.conv3x3 against the
    same layer in float64 (F.conv2d, F.elu, autograd) and a bit-identical
    rerun, then each pass's timings (kernel_timing.time_conv3x3)."""
    import torch.nn.functional as F

    from gppvae_tpu_torch import ops
    from gppvae_tpu_torch.ops.conv3x3 import out_size

    x = torch.randn(n, h, w, cin, device="cuda", generator=gen)
    wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (3 * cin ** 0.5)
    b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
    dy = torch.randn(n, out_size(h, stride, *pads[:2]), out_size(w, stride, *pads[2:]), cout,
                     device="cuda", generator=gen)

    def passes(fn, x, wt, b):
        x, wt, b = (t.detach().requires_grad_() for t in (x, wt, b))
        y = fn(x, wt, b)
        return [y.detach(), *torch.autograd.grad(y, (x, wt, b), dy.to(y.dtype))]

    def f64(x, wt, b):
        pt, pb, pl, pr = pads
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)), wt, b, stride)
        return (F.elu(y) if elu else y).permute(0, 2, 3, 1)

    kern = lambda x, wt, b: ops.conv3x3(x, wt, b, stride, pads, elu)  # noqa: E731
    got, again = passes(kern, x, wt, b), passes(kern, x, wt, b)
    want = passes(f64, x.double(), wt.double(), b.double())
    torch.cuda.synchronize()
    rel = [float((g.double() - t).abs().max() / t.abs().max()) for g, t in zip(got, want)]
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    label = f"conv3x3 {n}x{h}x{w} {cin}->{cout} stride {stride} pads {pads}"
    say(f"{label}: y, dX, dW, db max rel err {[f'{r:.2e}' for r in rel]} (bound "
        f"{CONV3X3_REL_BOUND:.0e}); bit-identical rerun {same}")
    check(max(rel) <= CONV3X3_REL_BOUND, f"{label} error")
    check(same, f"{label} is deterministic")
    rows = []
    for name, t in time_conv3x3(x, wt, b, dy, stride, pads, elu).items():
        say_timings(f"{label} {name}", t)
        rows.append({"shape": [n, h, w, cin, cout, stride, list(pads), name],
                     "max_abs_err": max(rel), **t})
    return rows


def nll_core_shapes() -> list[tuple[int, int, int]]:
    """SHAPES_NLL_CORE, then at L = 16 each R where the plan changes driver
    on this card, with the R below and above it."""
    from gppvae_tpu_torch.ops import _build
    from gppvae_tpu_torch.ops.nll_core import plan_nll_core

    props = _build.device_props(torch.cuda.current_device())
    drivers = [plan_nll_core(r, 16, props).driver for r in range(1, 2049)]
    cuts = [r for r in range(2, 2049) if drivers[r - 1] != drivers[r - 2]]
    say(f"nll_core's drivers on this card at L = 16: {drivers[0]} from R = 1, " + ", ".join(
        f"{drivers[r - 1]} from {r}" for r in cuts))
    return SHAPES_NLL_CORE + [(6400, r + d, 16) for r in cuts for d in (-1, 0, 1)]


def factor_prep_build() -> None:
    """The factor_prep kernels' registers and spills (nvcc's -Xptxas -v)
    and their tensor-core products in the built library (cuobjdump -sass):
    HMMA…TF32 instructions above 0, no spills."""
    from gppvae_tpu_torch.ops import _build

    entry = None
    for line in _build.nvcc_log().splitlines():
        if "Compiling entry" in line:
            entry = line if "factor_prep_kernel" in line else None
        elif entry and ("spill" in line or "registers" in line):
            bt = re.search(r"kernelILi(\d+)", entry)[1]
            say(f"  factor_prep build, tile edge {bt}: {line.strip()}")
            if "spill" in line:
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      "3: the factor_prep kernels do not spill")
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          timeout=300).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "factor_prep_kernel" in fn and "HMMA" in line and "TF32" in line:
            hmma[fn] = hmma.get(fn, 0) + 1
    say(f"  factor_prep SASS: HMMA…TF32 per kernel {sorted(hmma.values())}")
    check(len(hmma) == 3 and all(hmma.values()),
          "3: every factor_prep kernel runs its products on the tensor cores")


def phase_kernels() -> dict:
    from gppvae_tpu_torch import ops

    say("== 3 kernel vs plain, and the yardsticks (ms: CUDA events around the Python "
        "call, median of 50; device_ms: the call's device time, its launches queued "
        "behind a sleep)")
    factor_prep_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops.reset_launch_counts()
    stats = {
        "factor_prep": [check_factor_prep(gen, *s) for s in SHAPES_FACTOR_PREP],
        "woodbury_nll_core": [check_nll_core(gen, *s) for s in nll_core_shapes()],
        "conv3x3": [row for s in SHAPES_CONV3X3 for row in check_conv3x3(gen, *s)],
    }
    drivers = ops.driver_counts()
    say(f"3: nll_core launches per driver {drivers}")
    check(all(drivers.values()), "3: each of nll_core's drivers launched at least once")
    return stats


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
          and counts["nll_core_torch.cuda_calls"] == 0
          and counts["conv3x3_torch.cuda_calls"] == 0,
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


def report_flops(label: str, result, card: str) -> None:
    """The analytic FLOP of one epoch of this run (utils/flops.py: what the
    algorithm needs, 1 MAC = 2 FLOP) over the median sec_epoch of the steady
    epochs, against the card's fp32 peak outside the tensor cores."""
    from gppvae_tpu_torch.utils import flops

    cfg, data = result.config, result.data
    per_epoch = flops.gppvae_epoch_flops(
        image_shape=tuple(data["images_tr"].shape[1:]), enc_features=cfg.enc_features,
        dec_features=cfg.dec_features, zdim=cfg.zdim, n_train=data["images_tr"].shape[0],
        n_heldout=data["y_ho"].shape[0], batch_size=cfg.batch_size,
        rank=cfg.obj_feature_dim * (2 * cfg.view_num_freqs + 1))
    sec = statistics.median(h["sec_epoch"] for h in result.history[1:])
    rate = per_epoch["total"] / sec
    say(f"{label} analytic FLOP per epoch: {flops.format_tflops(per_epoch['total'])} ("
        + ", ".join(f"{k} {flops.format_tflops(v)}" for k, v in per_epoch.items() if k != "total")
        + f"); steady sec_epoch {sec:.4f} → {rate / 1e12:.3f} TFLOP/s achieved, "
        f"{rate / FP32_FLOPS:.4f} of the fp32 peak ({FP32_FLOPS / 1e12:.0f} TFLOP/s) on {card}")
    check(per_epoch["total"] > 0 and math.isfinite(rate), f"{label}: a finite FLOP rate")


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


GRAPH_COUNTERS = ("C.graph_capture", "C.graph_replay")


def graph_counts() -> dict:
    """Phase C's CUDA graphs so far: captures and replayed steps."""
    from gppvae_tpu_torch.utils import timers

    return {k: timers.TRACER.counts.get(k, 0) for k in GRAPH_COUNTERS}


def since(before: dict) -> dict:
    return {k: v - before[k] for k, v in graph_counts().items()}


def replays_per_epoch(fn):
    """(fn(), the steps replayed from a graph in each epoch fn ran), from
    the tracer's spans: C.graph_replay credited under each C_minibatch."""
    from gppvae_tpu_torch.utils import timers

    timers.take()
    timers.set_tracing(True)
    try:
        out = fn()
    finally:
        timers.set_tracing(False)
    spans = timers.take()
    epoch = {}
    for i, sp in enumerate(spans):
        epoch[i] = i if sp.parent == -1 and sp.name == "C_minibatch" else epoch.get(sp.parent)
    roots = [i for i, sp in enumerate(spans) if sp.parent == -1 and sp.name == "C_minibatch"]
    return out, [sum(sp.counts.get("C.graph_replay", 0) for i, sp in enumerate(spans)
                     if epoch[i] == r) for r in roots]


def phase_slice(tmp: str, card: str) -> tuple[dict, dict]:
    from gppvae_tpu_torch.train import train_gppvae, train_vae

    say("== 4 slice: train_vae 1 epoch → train_gppvae --mode joint 3 epochs "
        "(P=400, Q=16, zdim 16, R=56, bs 128, f32)")
    replays = []

    def run():
        train_vae.main([*SLICE_ARGS, "--epochs", "1", "--outdir", f"{tmp}/vae"])
        result, per_epoch = replays_per_epoch(lambda: train_gppvae.main([
            *SLICE_ARGS, "--mode", "joint", "--epochs", "3",
            "--vae_weights", f"{tmp}/vae/{train_vae.WEIGHTS_FILE}",
            "--outdir", f"{tmp}/gppvae",
        ]))
        replays.extend(per_epoch)
        return result

    result, counts = drive("4 slice", run)
    nb = -(-result.data["images_tr"].shape[0] // result.config.batch_size)
    from gppvae_tpu_torch.train.train_gppvae import WARMUP_STEPS

    say(f"4 slice: steps replayed from Phase C's CUDA graph per epoch {replays} of {nb}")
    check(len(replays) == 3 and replays[0] == nb - WARMUP_STEPS
          and all(r == nb for r in replays[1:]),
          "4: Phase C's graph replays every step after the warm-ups")
    hist = result.history
    report(hist)
    report_flops("4 slice", result, card)
    check(hist[-1]["loss"] < hist[0]["loss"], "loss falls from the first epoch to the last")
    check(counts["launch_factor_prep.launches"] == 3, "factor_prep launched once per epoch")
    check(counts["launch_nll_core.launches"] == 3, "nll_core launched once per epoch")
    Z, *_ = final_nll_check(result, "4 slice")
    check(Z.shape == (5700, 16), "latents (5700, 16)")
    return counts, {"dir": f"{tmp}/gppvae", "result": result, "data": DIGITS_DATA}


def _bf16_f64(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.bfloat16).double()


def merged_stage_f64(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """nearest-resize ×2 + a 3×3 conv as the JAX package's bfloat16 subpixel
    decoder computes it, in float64 on the CPU: the bf16 weight's taps merged
    per axis by T (rows, then columns, each sum rounded to bf16), the 4×4
    kernel over x dilated by 2 with padding 2, rounded to bf16, + the bf16
    bias, rounded. Returns (the bf16-rounded kernel, the stage's output)."""
    import torch.nn.functional as F

    T = torch.tensor([[1.0, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]], dtype=torch.float64)
    k4 = torch.einsum("up,oipq->oiuq", T, _bf16_f64(weight)).bfloat16().double()
    k4 = torch.einsum("vq,oiuq->oiuv", T, k4).bfloat16().double()
    x = _bf16_f64(x)
    n, c, h, w = x.shape
    u = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1))
    u[:, :, ::2, ::2] = x
    y = F.conv2d(u, k4, padding=2).bfloat16().double()
    return k4, (y + _bf16_f64(bias)[:, None, None]).bfloat16().double()


def check_decoder_bf16(label: str, decoder, z: torch.Tensor) -> None:
    """The trained decoder in bfloat16 on the card: the upsampling stages
    its forward ran (each `_upconv` call recorded with its input and output;
    torch.profiler's ATen ops: a transposed conv per stage and no nearest
    upsample), each stage's merged kernel against the CPU's bit for bit, and
    its output against merged_stage_f64 of the same input. The resize
    forward on the same inputs is printed beside it."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from gppvae_tpu_torch.models import vae

    stages, own = [], vae._upconv

    def recorded(layer, x, dtype):
        y = own(layer, x, dtype)
        stages.append((layer, x.detach(), y.detach()))
        return y

    vae._upconv = recorded
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
            logits = decoder(z)
        torch.cuda.synchronize()
    finally:
        vae._upconv = own
    ops = {e.key: e.count for e in prof.key_averages()}
    ran = {k: ops.get(k, 0) for k in ("aten::conv_transpose2d", "aten::upsample_nearest2d")}
    depth = len(decoder.convs)
    say(f"{label} bf16 decoder on the card: {len(stages)} _upconv stages of {depth}, "
        f"ATen ops {ran}; logits {tuple(logits.shape)} {logits.dtype}")
    check(decoder.upsample == "subpixel" and decoder.dtype == torch.bfloat16
          and len(stages) == depth and ran["aten::conv_transpose2d"] == depth
          and ran["aten::upsample_nearest2d"] == 0,
          f"{label}: the card ran the merged lowering, one transposed conv per stage")
    check(bool(torch.isfinite(logits).all()), f"{label}: finite bf16 logits")
    for i, (layer, x, y) in enumerate(stages):
        k4, ref = merged_stage_f64(layer.weight, layer.bias, x)
        card_k4 = vae._merge_taps(layer.weight.to(torch.bfloat16)).double().cpu()
        with torch.no_grad():
            resize = vae._conv(layer, F.interpolate(x, scale_factor=2, mode="nearest"),
                               torch.bfloat16)
        errs = {}
        for name, out in (("merged", y), ("resize", resize)):
            out = out.double().cpu()
            errs[name] = (float((out - ref).abs().max() / ref.abs().max()),
                          float((out != ref).double().mean()))
        say(f"{label} stage {i} {tuple(x.shape)} → {tuple(y.shape)} vs float64 merged: "
            f"max abs err / max |ref| {errs['merged'][0]:.3e} (bound "
            f"{DECODER_STAGE_REL_BOUND:.3e}), outputs off {errs['merged'][1]:.4%} (bound "
            f"{DECODER_STAGE_DIFFER_BOUND:.0%}); resize forward {errs['resize'][0]:.3e}, "
            f"{errs['resize'][1]:.2%} off; 4×4 kernel equal bit for bit "
            f"{torch.equal(card_k4, k4)}")
        check(torch.equal(card_k4, k4), f"{label} stage {i}: the card's merged kernel is the "
              "JAX einsum's rounding")
        check(errs["merged"][0] <= DECODER_STAGE_REL_BOUND
              and errs["merged"][1] <= DECODER_STAGE_DIFFER_BOUND,
              f"{label} stage {i}: the card's bf16 stage is the merged function")


def path_headline(tmp: str, card: str) -> tuple[dict, dict]:
    from gppvae_tpu_torch.models import encode_all
    from gppvae_tpu_torch.train import train_gppvae, train_vae

    say("== 5a headline (config 3b): bf16 + subpixel, train_vae 1 epoch → "
        "train_gppvae --mode joint 3 epochs, the last in f32 (--polish_epochs 1)")

    def run():
        train_vae.main([*SLICE_ARGS, *HEADLINE, "--epochs", "1", "--outdir", f"{tmp}/vae_bf16"])
        return train_gppvae.main([
            *SLICE_ARGS, *HEADLINE, "--mode", "joint", "--epochs", "3",
            "--polish_epochs", "1",
            "--vae_weights", f"{tmp}/vae_bf16/{train_vae.WEIGHTS_FILE}",
            "--outdir", f"{tmp}/headline",
        ])

    result, counts = drive("5a headline", run)
    hist = result.history
    report(hist)
    report_flops("5a headline", result, card)
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
    result.model.dtype = torch.bfloat16
    check_decoder_bf16("5a", result.model.decoder, Z_f32[:DECODER_CHECK_ROWS])
    result.model.dtype = torch.float32
    return counts, {"dir": f"{tmp}/headline", "result": result, "data": DIGITS_DATA}


def path_faces(tmp: str) -> tuple[dict, dict]:
    from gppvae_tpu_torch import ops
    from gppvae_tpu_torch.train import train_gppvae

    say("== 5b GP options at face-view 128² (config 4 widths): rbf (32 RFF) + object "
        "effect, learn_sigma_y, grad_accum 2, refresh every 3 steps, subpixel, 2 epochs")
    epochs, refresh = 2, 3
    graphs = graph_counts()
    result, counts = drive("5b faces", lambda: train_gppvae.main([
        *FACES_ARGS, "--mode", "joint", "--epochs", str(epochs), "--outdir", f"{tmp}/faces"]))
    hist = result.history
    report(hist)
    check(since(graphs) == {k: 0 for k in GRAPH_COUNTERS},
          "5b: accumulating steps run eager, no CUDA graph captured or replayed")
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
    rel = max_rel_err(got, want)
    check(rel <= FACTOR_PREP_REL_BOUND, "factor_prep at R = 232")
    G, UtZ, zn = want
    n, L = Z.shape
    k_out = ops.launch_nll_core(G, UtZ, zn, v_noise, n, L)
    p_out = ops.nll_core_torch(G, UtZ, zn, v_noise, n, L)
    verr, vrel = max_err(k_out[:1], p_out[:1])
    check(vrel <= NLL_VALUE_REL_BOUND, "nll_core at R = 232")
    say(f"trained inputs at N={n}, R={R}, L={L}: factor_prep rel {rel:.3e}, "
        f"nll_core rel {vrel:.3e}")
    return counts, {"dir": f"{tmp}/faces", "result": result, "data": FACES_DATA}


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
    from gppvae_tpu_torch import ops
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
    from gppvae_tpu_torch.ops import _build
    from gppvae_tpu_torch.ops.nll_core import plan_nll_core

    drivers = ops.driver_counts()
    planned = plan_nll_core(560, 16, _build.device_props(torch.cuda.current_device())).driver
    say(f"5d R=560: nll_core trained by its {planned} driver (launches per driver {drivers})")
    check(drivers[planned] == 1 == sum(drivers.values()), "5d: nll_core ran the planned driver")
    _, Vs, _, _ = final_nll_check(result, "5d R=560")
    check(Vs[0].shape[1] == 560, "R = 80·7 = 560")
    return counts


def cli(fn, argv) -> list[dict]:
    """Run a CLI's main(argv) as a user would; its JSON stdout lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def _pairs(ds, rows) -> str:
    return ",".join(f"{ds.object_ids[i]}:{ds.view_ids[i]}" for i in rows)


def _save_obs(path: str, ds, rows) -> str:
    np.savez_compressed(path, images=ds.images[rows], objects=ds.object_ids[rows],
                        views=ds.view_ids[rows])
    return path


def serve_run(label: str, run: dict) -> dict:
    """Path 6 on one trained run: generate (held-out MSE), generate
    --export_server, then serve --state for means and variances, observe,
    joint draws, the stdin loop and the two throughput modes, each through
    its main(argv) on the card. Returns the numbers."""
    from gppvae_tpu_torch import gp
    from gppvae_tpu_torch.config import build_dataset_from_flag
    from gppvae_tpu_torch.eval import generate, serving

    d = run["dir"]
    final_path, srv = f"{d}/final_params.pt", f"{d}/m.srv"
    with open(f"{d}/config.json") as f:
        side = json.load(f)
    arch = {k: side[k] for k in ARCH_KEYS}
    ds = build_dataset_from_flag(*run["data"])  # the grid the run trained on
    ho = ds.heldout_idx
    last_oos = run["result"].history[-1]["oos_mse"]
    out = {"label": label, "compute_dtype": arch["compute_dtype"],
           "image_shape": list(ds.image_shape), "n_train": len(ds.train_idx),
           "n_heldout": len(ho)}

    (rec,) = cli(generate.main, ["--state", final_path, "--device", "cuda", "--outdir", d])
    rel = abs(rec["heldout_mse"] - last_oos) / abs(last_oos)
    out.update(heldout_mse=rec["heldout_mse"], trainer_oos_mse=last_oos)
    say(f"{label} generate: held-out MSE {rec['heldout_mse']:.8f}, trainer's last oos_mse "
        f"{last_oos:.8f}, rel {rel:.3e}" + (f" (bound {HELDOUT_MSE_REL_BOUND:.0e})"
                                             if arch["compute_dtype"] == "float32" else
                                             " (bf16 serving of an f32-polished run: not held)"))
    if arch["compute_dtype"] == "float32":
        check(rel <= HELDOUT_MSE_REL_BOUND, f"{label}: generate's MSE is the trainer's")
    t0 = time.perf_counter()
    (exp,) = cli(generate.main, ["--state", final_path, "--device", "cuda",
                                 "--export_server", srv])
    out["export_cli_s"] = time.perf_counter() - t0

    # the fold alone (build_server_state, synced), best of 3 after the CLI's
    final = torch.load(final_path, map_location="cuda", weights_only=True)
    model, x_map = generate._model_and_xmap(final, ds, **arch)
    images_tr, d_tr, q_tr = generate._rows(ds, ds.train_idx, "cuda")
    folds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = serving.build_server_state(model, generate._params(final), final.get("fixed_W"),
                                           images_tr, d_tr, q_tr, x_map=x_map,
                                           extra_effects=tuple(arch["extra_effects"]))
        torch.cuda.synchronize()
        folds.append(time.perf_counter() - t0)
    out["fold_s"] = min(folds)

    state, meta = serving.load_server_state(srv, map_location="cuda")
    carried = [meta.get("nystrom_idx"), *(meta.get("rff_draws") or ())]
    tensors = [*state.core, state.X, state.W, state.v_sig, *state.vae_params.values(),
               *[t for t in carried if t is not None], *built.core, built.X, built.W]
    check(all(t.is_cuda for t in tensors), f"{label}: every state tensor on cuda")
    smodel = serving._model_from_meta(meta, state.vae_params, "cuda")
    sx_map = serving.x_map_from_meta(meta, state.X.shape[1])
    extra = tuple(meta["extra_effects"])
    check(smodel.dtype == (torch.bfloat16 if arch["compute_dtype"] == "bfloat16"
                           else torch.float32), f"{label}: served in the run's compute dtype")

    y_gen, _ = generate.generate_heldout(final, ds, **arch)
    (rec,) = cli(serving.main, ["--state", srv, "--device", "cuda", "--requests",
                                _pairs(ds, ho), "--var", "--outdir", f"{d}/served"])
    served = np.load(rec["npz"])["images"]
    err = float(np.abs(served - y_gen).max())
    out["latency_s"] = rec["latency_s"]
    say(f"{label} serve --requests ({len(ho)} held-out cells) --var: latency_s "
        f"{rec['latency_s']}, images vs generate's max abs err {err:.3e} "
        f"(bound {SERVE_IMAGE_ABS_BOUND:.0e}), rank {exp['rank']}")
    check(served.shape == y_gen.shape and err <= SERVE_IMAGE_ABS_BOUND,
          f"{label}: serve returns generate's held-out images")

    # observe: the variance of no observed cell rises; two folds equal one
    half = len(ho) // 2
    obs = {k: _save_obs(f"{d}/obs_{k}.npz", ds, rows)
           for k, rows in (("a", ho[:half]), ("b", ho[half:]), ("ab", ho))}
    orec, cli_observed = cli(serving.main, [
        "--state", srv, "--device", "cuda", "--observe", obs["ab"], "--save_state",
        f"{d}/ab.srv", "--requests", _pairs(ds, ho), "--var", "--outdir", f"{d}/observed"])
    out["observe_fold_s"] = orec["fold_s"]
    cli(serving.main, ["--state", srv, "--device", "cuda", "--observe", obs["a"],
                       "--save_state", f"{d}/a.srv"])
    cli(serving.main, ["--state", f"{d}/a.srv", "--device", "cuda", "--observe", obs["b"],
                       "--save_state", f"{d}/a_b.srv"])
    one, _ = serving.load_server_state(f"{d}/ab.srv", map_location="cuda")
    two, _ = serving.load_server_state(f"{d}/a_b.srv", map_location="cuda")
    d_ho = torch.as_tensor(ds.object_ids[ho], dtype=torch.int64, device="cuda")
    q_ho = torch.as_tensor(ds.view_ids[ho], dtype=torch.int64, device="cuda")
    _, vb = serving.predict_images(smodel, state, d_ho, q_ho, x_map=sx_map, extra_effects=extra,
                                   return_var=True)
    _, va = serving.predict_images(smodel, one, d_ho, q_ho, x_map=sx_map, extra_effects=extra,
                                   return_var=True)
    V, v_sigs = serving._effect_rows(one, d_ho, q_ho, x_map=sx_map, extra_effects=extra)
    m1 = gp.predict_from_core(V, one.core, v_sigs)
    m2 = gp.predict_from_core(V, two.core, v_sigs)
    split = float((m1 - m2).abs().max()) / float(m1.abs().max())
    worst = float(torch.max(va / vb))
    say(f"{label} observe ({len(ho)} cells): fold_s {orec['fold_s']}, variance after / before "
        f"max {worst:.6f} mean {float(torch.mean(va / vb)):.6f} (bound ≤ 1 + "
        f"{VAR_SLACK_REL:.0e}); two observes vs one: max |Δ mean| / max |mean| {split:.3e} "
        f"(bound {OBSERVE_SPLIT_REL_BOUND:.0e})")
    check(worst <= 1 + VAR_SLACK_REL, f"{label}: observe raises no observed cell's variance")
    check(split <= OBSERVE_SPLIT_REL_BOUND, f"{label}: two observes equal one over both")

    # joint draws over a batch that asks for one cell twice
    cells = [ho[0], ho[0], *ho[1:4]]
    (jrec,) = cli(serving.main, ["--state", srv, "--device", "cuda", "--requests",
                                 _pairs(ds, cells), "--sample", "4", "--joint",
                                 "--outdir", f"{d}/joint"])
    draws = np.load(jrec["npz"])["images"]
    check(draws.shape == (len(cells), 4, *ds.image_shape) and bool(np.isfinite(draws).all()),
          f"{label}: --sample 4 --joint finite, (n, K, H, W, C)")

    # the stdin loop
    lines = [_pairs(ds, ho[:100]), f"observe {obs['a']}", _pairs(ds, ho[:1]),
             f"save {d}/stdin.srv", "3:x"]
    old_stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        replies = cli(serving.main, ["--state", srv, "--device", "cuda", "--stdin",
                                     "--max_batch", "64", "--outdir", f"{d}/stdin"])
    finally:
        sys.stdin = old_stdin
    check(len(replies) == 1 + len(lines) and replies[0].get("ready") is True
          and replies[1]["n_requests"] == min(100, len(ho)) and replies[2]["observed"] == half
          and replies[4]["saved"] == f"{d}/stdin.srv" and "error" in replies[5],
          f"{label}: the stdin loop answers its lines")
    say(f"{label} stdin loop: {len(lines)} lines answered (request {replies[1]['latency_s']} s, "
        f"observe {replies[2]['fold_s']} s, save, one error)")

    # throughput at bench.py's 200-image request batch
    batch = np.tile(ho, -(-SERVE_BATCH // len(ho)))[:SERVE_BATCH]
    (trec,) = cli(serving.main, ["--state", srv, "--device", "cuda", "--requests",
                                 _pairs(ds, batch), "--repeat", str(SERVE_REPEAT), "--sustained",
                                 str(SERVE_CHAIN), "--outdir", f"{d}/throughput"])
    out.update({k: trec[k] for k in ("images_per_sec", "repeat_latency_s_min",
                                     "repeat_latency_s_median", "sustained_images_per_sec",
                                     "sustained_latency_s_min")},
               serve_batch=SERVE_BATCH, repeat=SERVE_REPEAT, sustained_chain=SERVE_CHAIN)
    say(f"{label} throughput, {SERVE_BATCH}-image batch: --repeat {SERVE_REPEAT} "
        f"{trec['images_per_sec']} images/s, --sustained {SERVE_CHAIN} "
        f"{trec['sustained_images_per_sec']} images/s")
    check(trec["images_per_sec"] > 0 and trec["sustained_images_per_sec"] > 0,
          f"{label}: positive rates")

    # the exported program: serve --export_exe, then serve --exe for the
    # same requests, flags and stdin lines, held to the --state replies above
    state_side = dict(rec=rec, served=served, observed=cli_observed, joint=draws,
                      cells=cells, stdin=replies, lines=lines, throughput=trec, core=one.core)
    out["exe"] = serve_exe_run(label, d, srv, ds, obs, batch, state_side)
    return out


def serve_exe_run(label: str, d: str, srv: str, ds, obs: dict, batch, state_side: dict) -> dict:
    """Path 6's exported program on one run: `serve --state m.srv --export_exe
    m.exe`, then `serve --exe m.exe` with --var, --sample 4 [--joint],
    --observe --save_core, --core, --stdin and the throughput modes, each
    reply held to the `serve --state` reply for the same flags (state_side).
    Returns the export's seconds and bytes and the --exe numbers."""
    from gppvae_tpu_torch.eval import serving

    ho = ds.heldout_idx
    exe = f"{d}/m.exe"
    t0 = time.perf_counter()
    (meta,) = cli(serving.main, ["--state", srv, "--device", "cuda", "--export_exe", exe])
    out = {"export_cli_s": time.perf_counter() - t0, "total_bytes": meta["total_bytes"],
           "platforms": meta["platforms"], "compute_dtype": meta["compute_dtype"],
           "entries": {k: {"export_s": e["export_s"], "bytes": e["bytes"]}
                       for k, e in meta["entry_points"].items()}}
    check(sorted(meta["entry_points"]) == sorted(serving._EXE_ENTRIES) and meta["platforms"]
          == ["cuda"] and os.path.isfile(f"{exe}.core.npz"),
          f"{label}: eight programs for cuda, the core npz and the meta")
    say(f"{label} serve --export_exe: {out['export_cli_s']:.2f} s, {meta['total_bytes']} bytes, "
        "per entry (s, bytes): " + ", ".join(
            f"{k} {e['export_s']} {e['bytes']}" for k, e in out["entries"].items()))

    def exe_cli(*flags, outdir: str) -> list[dict]:
        return cli(serving.main, ["--exe", exe, "--device", "cuda", *flags,
                                  "--outdir", f"{d}/{outdir}"])

    def images_err(a, b) -> float:
        check(a.shape == b.shape, f"{label}: --exe reply of shape {a.shape}, --state {b.shape}")
        return float(np.abs(a - b).max())

    def var_err(a, b) -> float:
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    # means and variances of the held-out cells
    (rec,) = exe_cli("--requests", _pairs(ds, ho), "--var", outdir="exe_served")
    errs = {"var_images": images_err(np.load(rec["npz"])["images"], state_side["served"]),
            "var": var_err(rec["posterior_var"], state_side["rec"]["posterior_var"])}
    check(rec["entry"] == "var", f"{label}: --exe --var reaches the var entry")
    out["latency_s"] = rec["latency_s"]

    # draws at one seed: joint (the --state run above drew at the default
    # seed 0) and independent (both surfaces at seed 3)
    cells = state_side["cells"]
    (jrec,) = exe_cli("--requests", _pairs(ds, cells), "--sample", "4", "--joint",
                      outdir="exe_joint")
    errs["joint_draws"] = images_err(np.load(jrec["npz"])["images"], state_side["joint"])
    (srec,) = cli(serving.main, ["--state", srv, "--device", "cuda", "--requests",
                                 _pairs(ds, cells), "--sample", "4", "--seed", "3",
                                 "--outdir", f"{d}/sample"])
    (erec,) = exe_cli("--requests", _pairs(ds, cells), "--sample", "4", "--seed", "3",
                      outdir="exe_sample")
    errs["draws"] = images_err(np.load(erec["npz"])["images"], np.load(srec["npz"])["images"])
    check(jrec["entry"] == "sample_joint" and erec["entry"] == "sample",
          f"{label}: --sample [--joint] reach the sample entries")

    # observe → save_core → core, against --observe --save_state above
    core_npz = f"{d}/ab.core.npz"
    orec, arec = exe_cli("--observe", obs["ab"], "--save_core", core_npz, "--requests",
                         _pairs(ds, ho), "--var", outdir="exe_observed")
    (crec,) = exe_cli("--core", core_npz, "--requests", _pairs(ds, ho), "--var",
                      outdir="exe_core")
    after = state_side["observed"]
    errs["observed_images"] = images_err(np.load(crec["npz"])["images"],
                                         np.load(after["npz"])["images"])
    errs["observed_var"] = max(var_err(arec["posterior_var"], after["posterior_var"]),
                               var_err(crec["posterior_var"], after["posterior_var"]))
    check(arec["entry"] == crec["entry"] == "predict_core",
          f"{label}: after --observe and under --core the predict_core entry answers")
    with np.load(core_npz) as f:
        core_rel = max(max_err([torch.from_numpy(f[k])], [getattr(state_side["core"], k).cpu()])[1]
                       for k in f.files)
    out["observe_fold_s"] = orec["fold_s"]
    (cjrec,) = exe_cli("--core", core_npz, "--requests", _pairs(ds, cells), "--sample", "4",
                       "--joint", outdir="exe_core_joint")
    (sjrec,) = cli(serving.main, ["--state", f"{d}/ab.srv", "--device", "cuda", "--requests",
                                  _pairs(ds, cells), "--sample", "4", "--joint",
                                  "--outdir", f"{d}/observed_joint"])
    errs["observed_joint_draws"] = images_err(np.load(cjrec["npz"])["images"],
                                              np.load(sjrec["npz"])["images"])
    check(cjrec["entry"] == "sample_joint_core", f"{label}: --core --sample --joint entry")

    # the stdin loop on the lines the --state loop got
    lines = [ln.replace(f"save {d}/stdin.srv", f"save {d}/stdin.core.npz")
             for ln in state_side["lines"]]
    old_stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        replies = exe_cli("--stdin", "--max_batch", "64", outdir="exe_stdin")
    finally:
        sys.stdin = old_stdin
    theirs = state_side["stdin"]
    check(len(replies) == len(theirs) and replies[0].get("exe") == exe
          and replies[2]["observed"] == theirs[2]["observed"]
          and replies[4]["saved"] == f"{d}/stdin.core.npz" and "error" in replies[5],
          f"{label}: the --exe stdin loop answers its lines")
    errs["stdin_var"] = max(var_err(replies[i]["posterior_var"], theirs[i]["posterior_var"])
                            for i in (1, 3))
    errs["stdin_images"] = max(images_err(np.load(replies[i]["npz"])["images"],
                                          np.load(theirs[i]["npz"])["images"]) for i in (1, 3))
    stdin_state, _ = serving.load_server_state(f"{d}/stdin.srv")
    with np.load(f"{d}/stdin.core.npz") as f:
        core_rel = max(core_rel, *(max_err([torch.from_numpy(f[k])],
                                           [getattr(stdin_state.core, k)])[1] for k in f.files))
    errs["core_rel"] = core_rel
    out["errors"] = errs
    image_bound = (EXE_IMAGE_ABS_BOUND_BF16 if meta["compute_dtype"] == "bfloat16"
                   else EXE_IMAGE_ABS_BOUND)
    say(f"{label} serve --exe vs serve --state, max abs err: " + json.dumps(errs)
        + f" (bounds: images {image_bound:.0e}, var {EXE_VAR_ABS_BOUND:.0e}, "
        f"core rel {EXE_CORE_REL_BOUND:.0e})")
    for k, v in errs.items():
        bound = (EXE_CORE_REL_BOUND if k == "core_rel" else EXE_VAR_ABS_BOUND if "var" in k
                 and "images" not in k else image_bound)
        check(v <= bound, f"{label}: --exe {k} within {bound:.0e} of --state ({v:.3e})")

    # throughput at the 200-image batch, beside --state's
    (trec,) = exe_cli("--requests", _pairs(ds, batch), "--repeat", str(SERVE_REPEAT),
                      "--sustained", str(SERVE_CHAIN), outdir="exe_throughput")
    ours = state_side["throughput"]
    out.update({k: trec[k] for k in ("images_per_sec", "repeat_latency_s_min",
                                     "repeat_latency_s_median", "sustained_images_per_sec",
                                     "sustained_latency_s_min")})
    say(f"{label} --exe throughput, {SERVE_BATCH}-image batch: --repeat {SERVE_REPEAT} "
        f"{trec['images_per_sec']} images/s (--state {ours['images_per_sec']}), --sustained "
        f"{SERVE_CHAIN} {trec['sustained_images_per_sec']} images/s (--state "
        f"{ours['sustained_images_per_sec']}); latency_s {out['latency_s']} (--state "
        f"{state_side['rec']['latency_s']}), observe fold_s {out['observe_fold_s']}")
    check(trec["entry"] == "mean" and trec["images_per_sec"] > 0
          and trec["sustained_images_per_sec"] > 0, f"{label}: positive --exe rates")
    return out


def path_serving(runs: dict) -> None:
    """Path 6: serve every kept run; the serving path launches neither GP
    kernel (gram and matmul_tn have no Pallas kernel in the JAX package) and
    no gradient, so each run's counts must all be 0 but conv3x3's forward,
    which a float32 model's encode and decode launch."""
    say("== 6 serving: generate --export_server, then serve --state (means, variances, "
        "observe, joint draws, the stdin loop, --repeat and --sustained), then serve "
        "--export_exe and the same through serve --exe, from paths 4, 5a, 5b")
    for label, run in runs.items():
        numbers, counts = drive(f"6 serving {label}", lambda: serve_run(label, run))
        counts.pop("launch_conv3x3.fprop")
        check(set(counts.values()) == {0}, f"6 serving {label}: no GP kernel or gradient "
              "launch, no plain version on a CUDA tensor")
        say(f"6 serving {label} numbers: {json.dumps(numbers)}")


def path_resume(tmp: str) -> list[dict]:
    """Path 7: an uninterrupted bf16 run with a 2-epoch float32 polish tail
    against the same run resumed at the switch and inside the window, and a
    profiled epoch. Returns each run's counts."""
    from gppvae_tpu_torch.train import train_gppvae, train_vae
    from gppvae_tpu_torch.utils.profiling import TRACE_FILE

    say("== 7 resume (P=400, Q=16, bf16, --polish_epochs 2, 4 epochs): uninterrupted vs "
        "resumed from state_0002 (the switch) and state_0003 (inside the window)")
    common = [*SLICE_ARGS, "--mode", "joint", "--dtype", "bfloat16", "--polish_epochs", "2",
              "--vae_weights", f"{tmp}/vae/{train_vae.WEIGHTS_FILE}"]
    out = f"{tmp}/resume"
    graphs = graph_counts()
    full, c_full = drive("7 uninterrupted", lambda: train_gppvae.main([
        *common, "--epochs", "4", "--checkpoint_every", "1", "--panel_every", "1",
        "--outdir", out]))
    say(f"7 uninterrupted: Phase C's CUDA graphs {since(graphs)}")
    check(since(graphs)["C.graph_capture"] == 2,
          "7 uninterrupted: one graph in bfloat16, one after the float32 switch")
    report(full.history)
    files = sorted(os.listdir(out))
    say(f"7 artifacts: {files}")
    want = ([f"panel_{e:04d}.png" for e in range(4)] + ["final_state", "final_params.pt"]
            + [f for e in (1, 2, 3) for f in (f"state_{e:04d}", f"state_{e:04d}.format.json")])
    check(all(f in files for f in want), f"7: panels and states on disk ({want})")
    all_counts = [c_full]
    nb = -(-full.data["images_tr"].shape[0] // full.config.batch_size)
    for start, label in ((2, "boundary"), (3, "mid-polish")):
        graphs = graph_counts()
        res, counts = drive(f"7 resumed from state_{start:04d} ({label})",
                            lambda: train_gppvae.main([
                                *common, "--epochs", "4", "--resume", f"{out}/state_{start:04d}",
                                "--outdir", f"{tmp}/resume_{start}"]))
        all_counts.append(counts)
        made = since(graphs)
        say(f"7 {label}: Phase C's CUDA graphs {made}")
        check(made["C.graph_capture"] == 1 and made["C.graph_replay"] > 0,
              f"7 {label}: the resumed run captures its graph after its state is loaded")
        epochs = [h["epoch"] for h in res.history]
        check(epochs == list(range(start, 4)), f"7 {label}: ran epochs {list(range(start, 4))}")
        check(res.model.dtype == torch.float32, f"7 {label}: the polish tail runs float32")
        worst = max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(res.history, full.history[start:]) for k in RESUME_KEYS)
        steps = (res.optimizers["vae"].steps, res.optimizers["gp"].steps)
        say(f"7 {label}: epochs {epochs}, worst relative difference over {RESUME_KEYS} "
            f"{worst:.3e} (bound {RESUME_REL_BOUND:.0e}); Adam steps {steps} "
            f"(two float32 epochs = {2 * nb})")
        check(worst <= RESUME_REL_BOUND, f"7 {label}: resumed = uninterrupted")
        check(steps == (2 * nb, 2 * nb), f"7 {label}: Adam steps counted from the switch")
        check(counts["launch_factor_prep.launches"] == 4 - start
              and counts["launch_nll_core.launches"] == 4 - start,
              f"7 {label}: each kernel launched once per epoch run")
    check(c_full["launch_factor_prep.launches"] == 4 and c_full["launch_nll_core.launches"] == 4,
          "7 uninterrupted: each kernel launched once per epoch")

    _, c_prof = drive("7 profiled epoch", lambda: train_gppvae.main([
        *common, "--epochs", "1", "--profile_dir", f"{tmp}/trace", "--panel_every", "0",
        "--outdir", f"{tmp}/profiled"]))
    trace = f"{tmp}/trace/{TRACE_FILE}"
    with gzip.open(trace, "rt") as f:
        kernels = len(re.findall(r'"cat":\s*"kernel"', f.read()))
    say(f"7 --profile_dir: {TRACE_FILE} {os.path.getsize(trace)} bytes for one epoch, "
        f"{kernels} CUDA kernel events")
    check(kernels > 0, "7: the trace holds CUDA kernel events")
    check(c_prof["launch_factor_prep.launches"] == 1 and c_prof["launch_nll_core.launches"] == 1,
          "7 profiled: each kernel launched once")
    return [*all_counts, c_prof]


def path_protocol(tmp: str) -> dict:
    """Path 8: the accuracy protocol on the card, then train-cvae through
    its CLI. Returns the protocol's counts."""
    import validate_torch
    from gppvae_tpu_torch import ops
    from gppvae_tpu_torch.train import train_cvae

    say(f"== 8 accuracy protocol: validate_torch.run_validation, {PROTOCOL_PRETRAIN} pretrain + "
        f"{PROTOCOL_EPOCHS} epochs, 180 digits × 16 views, f32")
    lines, launches_at, wall_at = [], {}, {}

    def emit(line: str, flush: bool = True) -> None:
        rec = json.loads(line)
        lines.append(rec)
        if "model" in rec:
            launches_at[rec["model"]] = ops.launch_counts()["launch_nll_core.launches"]
            wall_at[rec["model"]] = time.perf_counter() - t0
        say(f"  {line}")

    t0 = time.perf_counter()
    summary, counts = drive("8 protocol", lambda: validate_torch.run_validation(
        epochs=PROTOCOL_EPOCHS, pretrain=PROTOCOL_PRETRAIN, emit=emit, device="cuda"))
    say(f"8 protocol: wall {time.perf_counter() - t0:.1f} s; nll_core launches after each "
        f"model {launches_at}")
    # each trained stage's wall seconds (set-up and its evaluation included) per epoch
    stages = (("vae_pretrain", "baseline_per_view_mean", PROTOCOL_PRETRAIN),
              ("cvae", "livae", PROTOCOL_PRETRAIN + PROTOCOL_EPOCHS),
              ("gppvae_dis", "cvae", PROTOCOL_EPOCHS),
              ("gppvae_joint", "gppvae_dis", PROTOCOL_EPOCHS))
    say("8 protocol: wall s / epochs per stage: " + ", ".join(
        f"{m} {wall_at[m] - wall_at[prev]:.2f} / {n} = {(wall_at[m] - wall_at[prev]) / n:.4f}"
        for m, prev, n in stages))
    s = summary
    check(abs(s["baseline_train_mean"] - BASELINE_TRAIN_MEAN) <= BASELINE_ABS_BOUND
          and abs(s["baseline_per_view_mean"] - BASELINE_PER_VIEW_MEAN) <= BASELINE_ABS_BOUND,
          "8: the trivial baselines equal the JAX package's recorded values")
    check(s["verdict"] == "PASS", "8: verdict PASS")
    order = [max(s["gppvae_joint_oos_mse"], s["gppvae_dis_oos_mse"]), s["livae_oos_mse"],
             s["baseline_per_view_mean"], s["cvae_oos_mse"], s["baseline_train_mean"]]
    check(order == sorted(order), f"8: joint, dis < LIVAE < per-view-mean < CVAE < train-mean "
          f"({order})")
    check(launches_at["vae_pretrain"] == launches_at["livae"] == launches_at["cvae"] == 0,
          "8: VAE, LIVAE and CVAE launch no kernel")
    e = PROTOCOL_EPOCHS
    check(launches_at["gppvae_dis"] == e and launches_at["gppvae_joint"] == 2 * e
          and counts["launch_factor_prep.launches"] == 2 * e,
          "8: dis and joint launch each kernel once per epoch")
    check(len(lines) == 8, "8: seven model lines and the summary")

    say("== 8b train-cvae, 2 epochs at the protocol's width, through its main(argv)")
    res, c = drive("8b train-cvae", lambda: train_cvae.main([
        *PROTOCOL_ARGS, "--epochs", "2", "--lr", "1e-3", "--outdir", f"{tmp}/cvae"]))
    for h in res.history:
        say("  " + json.dumps(h))
    check(all(math.isfinite(v) for h in res.history for v in h.values() if isinstance(v, float)),
          "8b: every metric is finite")
    check(res.history[-1]["loss"] < res.history[0]["loss"], "8b: the loss falls")
    check(all(v == 0 for k, v in c.items() if "conv3x3" not in k),
          "8b: the CVAE launches no GP kernel")
    check(all(os.path.exists(f"{tmp}/cvae/{f}") for f in
              (train_cvae.WEIGHTS_FILE, "final_state", "oos_panel.png", "metrics.jsonl")),
          "8b: cvae_weights.pt, final_state, oos_panel.png, metrics.jsonl on disk")
    return counts


def _worst_rel(a: list[dict], b: list[dict], keys) -> float:
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for x, y in zip(a, b) for k in keys)


def dp_against_one(label: str, ranks: list[dict], singles: list[dict], keys) -> float:
    """Every rank's history against the first single-process run, within
    max(DP_REL_FLOOR, 10 × the two single runs' spread); returns the worst."""
    spread = _worst_rel(singles[1]["history"], singles[0]["history"], keys)
    bound = max(DP_REL_FLOOR, 10 * spread)
    worst = max(_worst_rel(r["history"], singles[0]["history"], keys) for r in ranks)
    say(f"{label}: {len(ranks)} ranks vs one process, worst relative difference over {keys} "
        f"{worst:.3e}; two single-process runs differ by {spread:.3e}; bound {bound:.1e}")
    check(worst <= bound, f"{label}: the ranks equal one process")
    check(all(r["digest"] == ranks[0]["digest"] for r in ranks),
          f"{label}: every rank holds the same parameter bits")
    return worst


def path_dp(tmp: str, card: str) -> tuple[dict, list[dict]]:
    """Path 9 (see the module docstring). Returns the ranks' summed launch
    counts of (a) and (a)'s two single-process runs."""
    from gppvae_tpu_torch.data import build_rotated_digits
    from gppvae_tpu_torch.eval import serving
    from gppvae_tpu_torch.models import VAE
    from gppvae_tpu_torch.parallel import RankPool, dryrun
    from gppvae_tpu_torch.train import train_vae

    say(f"== 9 data parallelism: {DP_WORLD} gloo ranks on {DP_DEVICE}; (a) GPPVAE-joint "
        "2 epochs at the slice's width, (b) train_vae 1 epoch, (c) DP serving")
    t_path = time.perf_counter()
    config = {**DP_GPPVAE, "vae_weights": f"{tmp}/vae/{train_vae.WEIGHTS_FILE}"}
    with RankPool(DP_WORLD, backend="gloo", device=DP_DEVICE) as pool:
        say(f"9 {DP_WORLD} ranks joined in {time.perf_counter() - t_path:.2f} s")
        # (a)
        singles = [dryrun.train_gppvae(DP_DATA, config, "cuda") for _ in range(2)]
        t0 = time.perf_counter()
        ranks = pool.run(dryrun.train_gppvae_rank, DP_DATA, config)
        wall = time.perf_counter() - t0
        keys = ("loss", "recon_term", "gp_term", "pen_term", "mse", "gp_nll_full", "v_sig",
                "v_noise", "oos_mse")
        dp_against_one("9a GPPVAE-joint", ranks, singles, keys)
        epochs = DP_GPPVAE["epochs"]
        for rank, r in enumerate(ranks):
            c = r["launches"]
            say(f"9a rank {rank} launch counts {c}")
            check(c["launch_factor_prep.launches"] == c["launch_nll_core.launches"] == epochs,
                  f"9a rank {rank}: each kernel launched once per epoch")
            check(c["factor_prep_torch.cuda_calls"] == c["nll_core_torch.cuda_calls"] == 0,
                  f"9a rank {rank}: no plain version on a CUDA tensor")
        check(all(s["launches"]["factor_prep_torch.cuda_calls"] == 0 for s in singles),
              "9a one process: no plain version on a CUDA tensor")
        n_params = sum(a.size for part in singles[0]["params"].values() for a in part.values())
        budget = 4 * (n_params + 6)
        for h, hs in zip(ranks[0]["history"], singles[0]["history"]):
            coll = h["collectives"]["all_reduce"]
            say(f"9a epoch {h['epoch']}: collectives {json.dumps(h['collectives'])} "
                f"(budget per call {budget} bytes: {n_params} parameters and 6 sums); "
                f"sec_epoch 2 ranks {h['sec_epoch']:.4f} (A {h['sec_A_encode']:.4f}, B "
                f"{h['sec_B_solve']:.4f}, C {h['sec_C_minibatch']:.4f}, eval "
                f"{h['sec_eval_oos']:.4f}), one process {hs['sec_epoch']:.4f} (C "
                f"{hs['sec_C_minibatch']:.4f}) on {card}")
            check(coll["max_bytes"] <= budget and set(h["collectives"]) == {"all_reduce"},
                  "9a: no collective larger than the gradient all-reduce")
        say(f"9a 2-rank run: {wall:.2f} s wall for {epochs} epochs and the set-up")
        dr = dryrun.dryrun(DP_WORLD, device=DP_DEVICE, pool=pool)
        say(f"9a dryrun: {json.dumps(dr)}")

        # (b)
        vae_singles = [dryrun.train_vae(DP_DATA, DP_VAE, "cuda") for _ in range(2)]
        vae_ranks = pool.run(dryrun.train_vae_rank, DP_DATA, DP_VAE)
        dp_against_one("9b train_vae", vae_ranks, vae_singles,
                       ("loss", "recon_term", "kl_term", "mse", "val_loss", "val_mse"))
        say(f"9b sec_epoch 2 ranks {vae_ranks[0]['history'][0]['sec_epoch']:.4f}, one process "
            f"{vae_singles[0]['history'][0]['sec_epoch']:.4f}")

        # (c)
        ds = build_rotated_digits(**DP_DATA)
        tr, ho = ds.train_idx, ds.heldout_idx
        params = singles[0]["params"]
        model_kw = dict(zdim=16, image_shape=tuple(ds.image_shape),
                        enc_features=(32, 64, 128), dec_features=(128, 64, 32))
        served = pool.run(dryrun.serving_rank, model_kw, params, None, ds.images[tr],
                          ds.object_ids[tr], ds.view_ids[tr], ds.object_ids[ho],
                          ds.view_ids[ho], ds.images[ho])
        model = VAE(**model_kw).to("cuda")
        on = {"vae": {k: torch.as_tensor(v, device="cuda") for k, v in params["vae"].items()},
              "gp": {k: torch.as_tensor(v, device="cuda") for k, v in params["gp"].items()}}

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device="cuda")

        state = serving.build_server_state(model, on, None, torch.as_tensor(ds.images[tr],
                                           device="cuda"), idx(ds.object_ids[tr]),
                                           idx(ds.view_ids[tr]))
        y, var = serving.predict_images(model, state, idx(ds.object_ids[ho]),
                                        idx(ds.view_ids[ho]), return_var=True)
        state2 = serving.observe(model, state, torch.as_tensor(ds.images[ho], device="cuda"),
                                 idx(ds.object_ids[ho]), idx(ds.view_ids[ho]))
        y2 = serving.predict_images(model, state2, idx(ds.object_ids[ho]),
                                    idx(ds.view_ids[ho]))
        one = dict(M=state.core.M, y=y, var=var, M2=state2.core.M, y2=y2)
        errs = {k: max(max_err([torch.from_numpy(r[k])], [v.cpu()])[1] for r in served)
                for k, v in one.items()}
        say(f"9c DP fold + predict_images + observe vs one process, max abs err / max |·|: "
            f"{json.dumps(errs)} (bound {DP_SERVE_REL_BOUND:.0e}); collectives "
            f"{json.dumps(served[0]['collectives'])}")
        check(all(e <= DP_SERVE_REL_BOUND for e in errs.values()),
              "9c: data-parallel serving equals one process")
    say(f"9 path: {time.perf_counter() - t_path:.1f} s")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}, singles


def per_axis(collectives: dict) -> dict:
    """{axis: {'calls', 'bytes', 'max_bytes'}} of one epoch's collectives
    (parallel.summary's kinds: unprefixed on the data axis)."""
    out: dict = {}
    for kind, row in collectives.items():
        axis = kind.split(".")[0] if "." in kind else "data"
        a = out.setdefault(axis, {"calls": 0, "bytes": 0, "max_bytes": 0})
        a["calls"] += row["calls"]
        a["bytes"] += row["bytes"]
        a["max_bytes"] = max(a["max_bytes"], row["max_bytes"])
    return out


def path_tp(tmp: str, card: str, singles: list[dict]) -> dict:
    """Path 10 (see the module docstring); `singles` are path 9's two
    single-process runs. Returns the ranks' summed launch counts of (a)."""
    from gppvae_tpu_torch.parallel import RankPool, dryrun
    from gppvae_tpu_torch.train import train_vae

    world = TP_MESH[0] * TP_MESH[1]
    say(f"== 10 tensor parallelism: {world} gloo ranks on {DP_DEVICE} as a {TP_MESH[0]} × "
        f"{TP_MESH[1]} data × model mesh; (a) GPPVAE-joint 2 epochs at the slice's width, "
        "(c) the 2-D dryrun, (d) a bfloat16 split conv")
    t_path = time.perf_counter()
    config = {**DP_GPPVAE, "vae_weights": f"{tmp}/vae/{train_vae.WEIGHTS_FILE}"}
    with RankPool(world, backend="gloo", device=DP_DEVICE, mesh=TP_MESH) as pool:
        say(f"10 {world} ranks joined in {time.perf_counter() - t_path:.2f} s")
        # (a)
        t0 = time.perf_counter()
        ranks = pool.run(dryrun.train_gppvae_rank, DP_DATA, config)
        wall = time.perf_counter() - t0
        keys = ("loss", "recon_term", "gp_term", "pen_term", "mse", "gp_nll_full", "v_sig",
                "v_noise", "oos_mse")
        dp_against_one("10a GPPVAE-joint on the 2 × 2 mesh", ranks, singles, keys)
        split = dryrun.check_blocks(ranks, TP_MESH[1])
        whole = ranks[0]["params"]["vae"]
        say("10a split weights, whole → each rank's block: " + json.dumps(
            {k: [list(whole[k].shape), list(ranks[0]["blocks"][k].shape)] for k in split}))
        check(set(split) == TP_SPLIT, f"10a: the seven weights split, got {split}")
        epochs = DP_GPPVAE["epochs"]
        for rank, r in enumerate(ranks):
            c = r["launches"]
            say(f"10a rank {rank} launch counts {c}")
            check(c["launch_factor_prep.launches"] == c["launch_nll_core.launches"] == epochs,
                  f"10a rank {rank}: each kernel launched once per epoch")
            check(c["factor_prep_torch.cuda_calls"] == c["nll_core_torch.cuda_calls"] == 0,
                  f"10a rank {rank}: no plain version on a CUDA tensor")
        for h, hs in zip(ranks[0]["history"], singles[0]["history"]):
            say(f"10a epoch {h['epoch']}: collectives per axis "
                f"{json.dumps(per_axis(h['collectives']))}; by kind "
                f"{json.dumps(h['collectives'])}")
            say(f"10a epoch {h['epoch']}: sec_epoch 2 × 2 mesh {h['sec_epoch']:.4f} (A "
                f"{h['sec_A_encode']:.4f}, B {h['sec_B_solve']:.4f}, C "
                f"{h['sec_C_minibatch']:.4f}, eval {h['sec_eval_oos']:.4f}), one process "
                f"{hs['sec_epoch']:.4f} (A {hs['sec_A_encode']:.4f}, B {hs['sec_B_solve']:.4f}, "
                f"C {hs['sec_C_minibatch']:.4f}, eval {hs['sec_eval_oos']:.4f}) on {card}")
            check({"data", "model", "world"} <= set(per_axis(h["collectives"])),
                  "10a: collectives on every axis")
        say(f"10a mesh run: {wall:.2f} s wall for {epochs} epochs and the set-up")

        # (c)
        dr = dryrun.dryrun(world, device=DP_DEVICE, pool=pool)
        say(f"10c dryrun: {json.dumps(dr)}")

        # (d)
        rng = np.random.default_rng(0)
        w = (rng.standard_normal((64, 32, 3, 3)) / 17).astype(np.float32)
        b = rng.standard_normal(64).astype(np.float32)
        x = rng.standard_normal((128, 32, 16, 16)).astype(np.float32)
        dy = rng.standard_normal((128, 64, 16, 16)).astype(np.float32)
        got = pool.run(dryrun.column_parallel_rank, "conv", w, b, x, dy, "bfloat16")
        with torch.no_grad():
            want = torch.nn.functional.conv2d(
                *(torch.as_tensor(a, device="cuda").bfloat16() for a in (x, w, b)),
                padding=1).float().cpu()
        err = max(max_err([torch.from_numpy(r["y"])], [want])[1] for r in got)
        say(f"10d bfloat16 conv split over the model axis vs unsplit on the card: max abs err "
            f"/ max |y| {err:.3e} (bound {TP_BF16_REL_BOUND:.0e}); collectives "
            f"{json.dumps(got[0]['collectives'])}")
        check(err <= TP_BF16_REL_BOUND, "10d: the bfloat16 split conv equals the unsplit one")
    say(f"10 path: {time.perf_counter() - t_path:.1f} s")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def stream_fingerprint(batches, eps, n: int) -> dict:
    """PRNG_GOLDEN's keys of one epoch's plan and ε."""
    perm = batches.reshape(-1)[:n].numpy().astype(np.int64)
    e = eps.numpy().astype(np.float64)
    return {"perm_head": perm[:8].tolist(), "perm_checksum": int(np.sum(np.arange(n) * perm)),
            "eps_head": [float(x) for x in eps[0, 0, :6]], "eps_sum": float(e.sum()),
            "eps_sumsq": float((e * e).sum())}


def path_stream(tmp: str) -> dict:
    """Path 12: the JAX package's random stream (see PRNG_GOLDEN)."""
    from gppvae_tpu_torch.models import VAE
    from gppvae_tpu_torch.train import train_gppvae, train_vae

    say(f"== 12 the JAX package's stream: train_vae 1 epoch → train_gppvae --mode joint "
        f"{STREAM_EPOCHS} epochs at seed 0 (P=400, Q=16, zdim 16, R=56, bs 128, f32)")
    t_path = time.perf_counter()
    keys = np.stack(train_gppvae.run_keys(0))
    check(np.array_equal(keys, np.array(PRNG_GOLDEN["split"], np.uint32)),
          f"12: split(PRNGKey(0), 4) = {keys.tolist()} is jax.random's")
    init = VAE(16, (32, 32, 1), key=keys[1]).state_dict()
    sums = {k: float(np.abs(v.numpy()).sum(dtype=np.float64)) for k, v in init.items()
            if k.endswith("weight")}
    worst = max(abs(sums[k] / v - 1) for k, v in PRNG_GOLDEN["init_abs_sums"].items())
    say(f"12 flax init from the init key: Σ|w| of {len(sums)} weights, worst rel err {worst:.3e}")
    check(set(sums) == set(PRNG_GOLDEN["init_abs_sums"]) and worst <= PRNG_SUM_REL_BOUND,
          "12: flax's VAE.init from the init key")
    seen = {}
    own = train_gppvae.make_draws

    def recording(*args, **kwargs):  # the trainer's own draws, kept as drawn
        draws = own(*args, **kwargs)

        def rec(epoch):
            seen[epoch] = draws(epoch)
            return seen[epoch]
        return rec

    def run():
        train_vae.main([*SLICE_ARGS, "--epochs", "1", "--outdir", f"{tmp}/stream_vae"])
        return train_gppvae.main([
            *SLICE_ARGS, "--mode", "joint", "--epochs", str(STREAM_EPOCHS),
            "--vae_weights", f"{tmp}/stream_vae/{train_vae.WEIGHTS_FILE}",
            "--outdir", f"{tmp}/stream"])

    train_gppvae.make_draws = recording
    try:
        result, counts = drive("12 stream", run)
    finally:
        train_gppvae.make_draws = own
    report(result.history)
    batches, _, eps = seen[0]
    got = stream_fingerprint(batches, eps, 5700)
    say(f"12 epoch 0's draws: plan {tuple(batches.shape)}, ε {tuple(eps.shape)}: " + json.dumps(got))
    check(got["perm_head"] == PRNG_GOLDEN["perm_head"]
          and got["perm_checksum"] == PRNG_GOLDEN["perm_checksum"],
          "12: epoch 0's plan is jax.random.permutation's")
    check(got["eps_head"] == PRNG_GOLDEN["eps_head"]
          and all(abs(got[k] / PRNG_GOLDEN[k] - 1) <= PRNG_SUM_REL_BOUND
                  for k in ("eps_sum", "eps_sumsq")),
          "12: epoch 0's ε of all 45 steps is jax.random.normal's")
    check(sorted(seen) == list(range(STREAM_EPOCHS)), f"12: one draw per epoch ({sorted(seen)})")
    for kernel in ("launch_factor_prep.launches", "launch_nll_core.launches"):
        check(counts[kernel] == STREAM_EPOCHS, f"12: {kernel} once per epoch")
    say(f"12 path: {time.perf_counter() - t_path:.1f} s")
    return counts


def main() -> None:
    t_start = time.perf_counter()
    kind, card = phase_environment()
    phase_build()
    stats = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        c4, r4 = phase_slice(tmp, card)
        c5a, r5a = path_headline(tmp, card)
        c5b, r5b = path_faces(tmp)
        paths = [c4, c5a, c5b, path_nystrom(), path_large_rank()]
        path_serving({"4 slice": r4, "5a headline": r5a, "5b faces": r5b})
        paths += [*path_resume(tmp), path_protocol(tmp)]
        c9, singles = path_dp(tmp, card)
        paths += [c9, path_tp(tmp, card, singles), path_stream(tmp)]
    sources = {
        "factor_prep": ("gppvae_tpu_torch/csrc/factor_prep.cu",
                        "gppvae_tpu/ops/pallas_gemm.py:162", "launch_factor_prep.launches"),
        "woodbury_nll_core": ("gppvae_tpu_torch/csrc/nll_core.cu",
                              "gppvae_tpu/ops/pallas_chol.py:167", "launch_nll_core.launches"),
    }
    sources["conv3x3"] = ("gppvae_tpu_torch/csrc/conv3x3.cu", None, "launch_conv3x3.fprop")
    kernels = []
    for name, (src, rep, key) in sources.items():
        per_path = [c[key] for c in paths]
        if rep is None:  # no TPU kernel: the float32 VAE's paths launch it, bfloat16's not
            check(any(per_path), f"{name} launched in a path: {per_path}")
        else:
            check(all(per_path), f"{name} launched in every path: {per_path}")
        main_shape = stats[name][0]  # the main path's (phase 4)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(per_path),
                        **{k: main_shape[k] for k in KERNEL_KEYS}})
    for name, rows in stats.items():
        say(f"{name} at every shape: " + json.dumps(
            [{"shape": row["shape"], **{k: row[k] for k in (*KERNEL_KEYS, "host_ms", "driver")}}
             for row in rows]))
    say(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all, the build included")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
