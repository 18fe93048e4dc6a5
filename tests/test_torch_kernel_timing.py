"""The card-free parts of utils/kernel_timing.py, on the CPU.

`max_rel_err` holds each output of a kernel to its own scale, as
tests/test_torch_cuda.py's `_rel_err` does: chip_smoke.py's phase 3 checks
factor_prep's (G, UᵀZ, ‖Z‖²) with it, where
dividing by the largest |want| of all three (‖Z‖² ≈ N·L) would let an error
in G of a thousand times the bound pass. `per_call_us` turns torch.profiler's
per-kernel totals into a time per call that stays right when the profiler
drops some launches.
"""

import pytest
import torch
from _one_thread import one_thread  # noqa: F401

from gppvae_tpu_torch.utils import kernel_timing as kt


def _outputs(n=5700, r=56, l=16):
    gen = torch.Generator().manual_seed(0)
    U = torch.randn(n, r, generator=gen) / r ** 0.5
    Z = torch.randn(n, l, generator=gen)
    return U.T @ U, U.T @ Z, torch.sum(Z * Z)


@pytest.mark.parametrize("which", [0, 1])
def test_each_output_is_held_to_its_own_scale(which):
    """An error of 1e-4 of G's (or UᵀZ's) own scale: the per-output reading
    sees it past the 1e-5 bound, one scale for all three does not."""
    want = _outputs()
    got = list(want)
    got[which] = want[which] + 1e-4 * want[which].abs().max()
    assert kt.max_rel_err(got, want) == pytest.approx(1e-4, rel=1e-3)
    assert kt.max_rel_err(got, want) > kt.FACTOR_PREP_REL_BOUND
    assert kt.max_err(got, want)[1] < kt.FACTOR_PREP_REL_BOUND  # the old, shared scale
    assert kt.max_rel_err(want, want) == 0.0


@pytest.mark.parametrize("dropped", [0, 1, 7])
def test_per_call_time_survives_dropped_launches(dropped):
    """50 calls of two kernels (one launched twice a call): a profiler that
    recorded `dropped` fewer launches of each still reads 3 + 2·5 µs."""
    reps = 50
    kernels = [(3.0 * (reps - dropped), reps - dropped),
               (5.0 * (2 * reps - dropped), 2 * reps - dropped)]
    assert kt.per_call_us(kernels, reps) == pytest.approx(13.0)
    assert kt.per_call_us([(0.0, 0)], reps) == 0.0
