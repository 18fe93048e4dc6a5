"""Timing a kernel on the card against its plain version and its library call.

The port's counterpart of the part of tools/kernel_ab.py that bench.py
imports: `chip_smoke.py` (phase 3) and `bench_torch.py` (the kernels block)
time the two CUDA kernels with these functions and hold them to the same
bounds. Every timing here synchronises the card; call them on CUDA tensors.

The peaks are NVIDIA's data sheet for the H100 SXM, dense, at the full 700 W
power limit: a card set below it reaches less, so a result names the card's
power limit beside it.
"""

from __future__ import annotations

import statistics

import torch

FP32_FLOPS = 67e12  # fp32 outside the tensor cores
BF16_FLOPS = 989e12  # bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12

# a kernel against its plain version on the same inputs
FACTOR_PREP_REL_BOUND = 1e-5  # max abs err / max |plain|, fp32 sums of N terms
NLL_VALUE_REL_BOUND = 1e-5
NLL_GRAD_REL_BOUND = 1e-4  # per gradient, err / max |plain grad|


def max_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) over paired tensors."""
    err = max(float((g - w).detach().abs().max()) for g, w in zip(got, want))
    scale = max(float(w.detach().abs().max()) for w in want)
    return err, err / max(scale, 1e-30)


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
    """The five numbers of one kernel at one shape, `host_ms` (ms −
    device_ms: what the call costs beyond the device's work) and `driver`,
    the nll_core driver that `kernel` ran (ops.driver_counts(); None where
    it ran none). The event timings come first, so that no profiler run of
    this shape precedes them."""
    from gppvae_tpu_torch import ops

    b_ms, b_by = bound(flop, nbytes)
    before = ops.driver_counts()
    t = {"ms": time_ms(kernel)}
    ran = [d for d, n in ops.driver_counts().items() if n > before[d]]
    t.update(plain_ms=time_ms(plain), library_ms=time_ms(library))
    d_ms, method = device_ms(kernel)
    return {**t, "device_ms": d_ms, "device_ms_method": method, "host_ms": t["ms"] - d_ms,
            "driver": ",".join(ran) or None, "bound_ms": b_ms, "bound_by": b_by}


def time_factor_prep(U: torch.Tensor, Z: torch.Tensor) -> dict:
    """timings() of factor_prep on the card's U (N, R) and Z (N, L): the
    kernel, the plain version, and one GEMM Uᵀ[U | Z] as the library call
    (‖Z‖² left out). It needs N·R·(R + 1) + 2·N·R·L FLOP (G is symmetric)
    and moves U, Z, G, UᵀZ and ‖Z‖² once."""
    from gppvae_tpu_torch import ops

    (n, r), l = U.shape, Z.shape[1]
    UZ = torch.cat([U, Z], 1)
    return timings(lambda: ops.launch_factor_prep(U, Z), lambda: ops.factor_prep_torch(U, Z),
                   lambda: torch.mm(U.T, UZ), flop=n * r * (r + 1) + 2.0 * n * r * l,
                   nbytes=4.0 * (n * (r + l) + r * (r + l) + 1))
