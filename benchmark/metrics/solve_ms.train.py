"""solve_ms.train: Phase B, the NLL and its Taylor coefficients through both kernels
(gp/taylor.py, gp/woodbury.py), milliseconds per epoch: the trainer's `sec_B_solve` span, averaged over
the unprofiled window's epochs."""

from benchmark.metrics._phase import mean


def read(run):
    return mean(run, "B_solve", 1e3)
