"""Profiling hook of the trainers (`profile_dir`).

Counterpart of gppvae_tpu/utils/profiling.py: `maybe_trace(dir, device)`
wraps the epochs in `torch.profiler.profile` (CPU activity and, on a CUDA
device, CUDA activity) and writes a Chrome trace, `trace.json.gz`, under
`dir` (open it in chrome://tracing or Perfetto). The port's tracer is on
meanwhile (utils/timers.py), so the trace shows the phases, each Phase C step
and its parts, and the host's reads of device values, by name. Unlike the JAX
version, a profiler that does not work is an error: on a CUDA device a trace
without a single device event raises.
"""

from __future__ import annotations

import contextlib
import os

import torch

from gppvae_tpu_torch.utils.timers import TRACER

TRACE_FILE = "trace.json.gz"


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, device: torch.device):
    if not trace_dir:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was_on = TRACER.on
    TRACER.set_tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        TRACER.set_tracing(was_on)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    if device.type == "cuda" and not any(
            ev.device_type == DeviceType.CUDA for ev in prof.key_averages()):
        raise RuntimeError(
            f"profile_dir={trace_dir!r}: torch.profiler recorded no CUDA event on {device}")
