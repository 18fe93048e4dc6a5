"""Hot ops: the port's kernels and their dispatch.

The GP's two have the same public names as gppvae_tpu/ops/dispatch.py
(`factor_prep`, `woodbury_nll_core`). Their version is chosen by the
tensor's device, not by a backend switch: a CPU tensor takes the plain
PyTorch version, a CUDA float32 tensor launches the hand-written CUDA kernel
(csrc/), anything else raises. There is no fallback from the kernel to the
plain version. `conv3x3` is the VAE's 3×3 convolution in NHWC with its bias
and ELU (ops/conv3x3.py), on its kernels alone (float32 CUDA tensors); the
VAE picks it or the plain `conv3x3_torch` by device and dtype. Its kernels
replace no TPU kernel (the JAX package leaves its convolutions to XLA).

The plain versions are exported under their own names for the tests and
for chip_smoke.py's kernel-vs-plain comparison; the main path never calls
them on a CUDA tensor (`cuda_calls` counts it if something does). Each
kernel wrapper counts its launches (`launches`), each plain version its
calls on any device (`calls`, `plain_calls()`: what the CPU runs in place
of a launch); nll_core's launches are also counted per driver
(`driver_counts()`: "cta", "cluster", "grid"), and conv3x3's per pass
(`launch_conv3x3.fprop`, `.dgrad`, `.wgrad`). The counts are counters of
the port's tracer (utils/timers.py), so a traced span holds the launches made
inside it. `uncounted()` leaves every count as it was after a block that
compares or times a kernel against its plain version, which is not the
path's work.

`gram`, `matmul_tn` and `sqnorm` have no kernel (gppvae_tpu/ops/
pallas_gemm.py:239-241): the GP layer writes them as plain products.
"""

import contextlib

from gppvae_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_torch
from gppvae_tpu_torch.ops.conv3x3 import COUNTERS as _CONV_COUNTERS
from gppvae_tpu_torch.ops.factor_prep import (
    factor_prep,
    factor_prep_torch,
    launch_factor_prep,
)
from gppvae_tpu_torch.ops.nll_core import (
    launch_nll_core,
    nll_core_torch,
    woodbury_nll_core,
    woodbury_nll_core_torch,
)
from gppvae_tpu_torch.utils.timers import TRACER

_LAUNCHES = ("launch_factor_prep.launches", "launch_nll_core.launches",
             "factor_prep_torch.cuda_calls", "nll_core_torch.cuda_calls",
             *_CONV_COUNTERS, "conv3x3_torch.cuda_calls")
_DRIVERS = tuple(f"launch_nll_core.drivers.{d}" for d in launch_nll_core.drivers)
_CALLS = {"factor_prep": "factor_prep_torch.calls", "woodbury_nll_core": "nll_core_torch.calls",
          "conv3x3": "conv3x3_torch.calls"}


def launch_counts() -> dict[str, int]:
    """Kernel launches and plain-version calls on CUDA tensors so far."""
    return {name: TRACER.counts.get(name, 0) for name in _LAUNCHES}


def driver_counts() -> dict[str, int]:
    """nll_core's launches per driver so far (their sum is its launches)."""
    return dict(launch_nll_core.drivers)


def reset_launch_counts() -> None:
    for name in (*_LAUNCHES, *_DRIVERS):
        TRACER.counts[name] = 0


def plain_calls() -> dict[str, int]:
    """Calls of each kernel's plain version so far, on any device."""
    return {k: TRACER.counts.get(name, 0) for k, name in _CALLS.items()}


@contextlib.contextmanager
def uncounted():
    """Every count (launch_counts, driver_counts, plain_calls) after the
    block as before it."""
    names = (*_LAUNCHES, *_DRIVERS, *_CALLS.values())
    saved = {name: TRACER.counts.get(name, 0) for name in names}
    try:
        yield
    finally:
        TRACER.counts.update(saved)


__all__ = [
    "conv3x3", "conv3x3_torch", "driver_counts", "factor_prep", "factor_prep_torch",
    "launch_counts",
    "launch_factor_prep", "launch_nll_core", "nll_core_torch", "plain_calls",
    "reset_launch_counts", "uncounted", "woodbury_nll_core", "woodbury_nll_core_torch",
]
