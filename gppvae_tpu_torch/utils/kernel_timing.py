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
import time

import torch

FP32_FLOPS = 67e12  # fp32 outside the tensor cores
BF16_FLOPS = 989e12  # bfloat16 on the tensor cores
# float32-accurate products on the tensor cores: split TF32 (x = hi + lo,
# lo·hi + hi·lo + hi·hi) takes three TF32 passes at 495 TFLOP/s each
SPLIT_TF32_FLOPS = 495e12 / 3
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


def max_rel_err(got, want) -> float:
    """The largest of each output's max abs error / its own max |want|: a
    small output (G beside ‖Z‖²) is held to its own scale, not the
    largest one's."""
    return max(max_err([g], [w])[1] for g, w in zip(got, want))


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


def per_call_us(kernels, reps: int) -> float:
    """µs per call from (µs, count) of each kernel recorded over `reps`
    calls: its mean per recorded launch times its launches per call (its
    count over reps, rounded). A later profiler session of a process can
    record fewer kernels than were launched, and dividing the recorded time
    by reps would count the missing ones as free."""
    return sum(us / n * max(1, round(n / reps)) for us, n in kernels if n)


def _profile(fn, reps: int) -> tuple[float, int]:
    """(µs of CUDA kernels per call by per_call_us, kernels recorded) in
    torch.profiler's key_averages() over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
    return (per_call_us([(ev.self_device_time_total, ev.count) for ev in kernels], reps),
            sum(ev.count for ev in kernels))


def profiled_ms(fn, reps: int = 50) -> tuple[float, int]:
    """torch.profiler's view of `reps` calls: ms per call (_profile), and
    how many kernels it recorded (reps × the kernels of one call, where
    none was dropped)."""
    us, seen = _profile(fn, reps)
    return (us / 1e3 if seen else float("nan")), seen


def _queued(fn, reps: int) -> tuple[float, bool]:
    """(ms per call between CUDA events around `reps` calls enqueued behind
    torch.cuda._sleep, whether the sleep outlasted the enqueue). The sleep
    is twice what `reps` calls took with a synchronise (at 2 GHz), so the
    calls run back to back unless `fn` waits for the device itself."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int(2 * 2e9 * (time.perf_counter() - t0)) + (1 << 20)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    hidden = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps, hidden


def queued_ms(fn, reps: int = 50) -> float:
    """Device milliseconds per call: CUDA events around `reps` calls that the
    host enqueued while the stream slept, so that they run back to back and
    the host's enqueue time is hidden (for a `fn` that does not wait for
    the device itself)."""
    return _queued(fn, reps)[0]


def device_ms(fn, reps: int = 50, most: float | None = None) -> tuple[float | None, str]:
    """The call's device time and how it was read: "queued" (queued_ms), or,
    where `fn` waits for the device itself so that its launches cannot
    queue, or where the queued reading is above `most` (the call's own
    `ms`: back-to-back calls then cost more than one alone, and the
    reading is not one call's device time), "profiler" (_profile over
    reps); None and "not resolved" where the profiler recorded no kernel."""
    ms, hidden = _queued(fn, reps)
    if hidden and (most is None or ms <= most):
        return ms, "queued"
    us, seen = _profile(fn, reps)
    return (us / 1e3, "profiler") if seen else (None, "not resolved")


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): FLOP over the rate of
    float32-accurate products on the tensor cores (split TF32, a third of
    the TF32 peak: both kernels' products run so, and a kernel that does may
    beat the 67 TFLOP/s of the CUDA cores), bytes (each input read once,
    each output written once) over the memory rate."""
    t_op, t_mem = flop / SPLIT_TF32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
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
    d_ms, method = device_ms(kernel, most=t["ms"])
    return {**t, "device_ms": d_ms, "device_ms_method": method,
            "host_ms": None if d_ms is None else t["ms"] - d_ms,
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


def time_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy: torch.Tensor,
                 stride: int, pads, elu: bool) -> dict:
    """timings() of conv3x3 on the card's x (NHWC), OIHW w, b and the
    output's gradient dy (NHWC), through the calls a training step makes
    (ops/conv3x3.py `fprop`, `grads`): "fprop" (bias and ELU fused);
    "dgrad" and "wgrad", a layer's backward with only dX or only dW, db
    (each with its ELU′ pass where `elu`); "backward", the whole of it.
    The plain version is conv3x3_torch and autograd; the library calls are
    cuDNN's float32 F.conv2d and its backward (aten convolution_backward
    from g = dy·ELU′). Each GEMM pass needs 2·P·Cout·9·Cin FLOP (P output
    pixels; db adds 2·P·Cout) and moves its inputs and outputs once."""
    import torch.nn.functional as F

    from gppvae_tpu_torch import ops
    from gppvae_tpu_torch.ops.conv3x3 import fprop, grads

    pads = tuple(pads)
    cout, cin = w.shape[:2]
    P = dy.numel() // cout
    y, lay = fprop(x, w, b, stride, pads, elu)
    ys = y if elu else None
    pt, pb, pl, pr = pads
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    gn = (dy * torch.where(y > 0, 1.0, y + 1.0) if elu else dy).permute(0, 3, 1, 2)
    xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))

    def kernel(want_x, want_w):
        return lambda: grads(lay, dy, x, w, ys, want_x, want_w)

    def plain(wanted):
        return lambda: torch.autograd.grad(ops.conv3x3_torch(xr, wr, br, stride, pads, elu),
                                           wanted, dy)

    def library(mask):
        return lambda: torch.ops.aten.convolution_backward(
            gn, xp, w, [cout], [stride] * 2, [0, 0], [1, 1], False, [0, 0], 1, mask)

    flop = 2.0 * P * cout * 9 * cin
    xb, yb, wb = 4.0 * x.numel(), 4.0 * dy.numel(), 4.0 * (w.numel() + cout)
    gb = (2 if elu else 1) * yb  # dy, and y for ELU′
    return {
        "fprop": timings(lambda: fprop(x, w, b, stride, pads, elu),
                         lambda: ops.conv3x3_torch(x, w, b, stride, pads, elu),
                         lambda: F.conv2d(xp, w, b, stride), flop, xb + wb + yb),
        "dgrad": timings(kernel(True, False), plain([xr]), library([True, False, False]),
                         flop, gb + wb + xb),
        "wgrad": timings(kernel(False, True), plain([wr, br]), library([False, True, True]),
                         flop + 2.0 * P * cout, gb + xb + wb),
        "backward": timings(kernel(True, True), plain([xr, wr, br]),
                            library([True, True, True]), 2 * flop + 2.0 * P * cout,
                            gb + 2 * xb + 2 * wb),
    }
