"""factor_prep_roofline: the least time of one factor_prep launch at the
cell's (N, R, L), its FLOP at dense TF32 or its bytes at HBM bandwidth
(yardstick/kernel_cost.py, yardstick/peaks.py), over the kernel's mean
device time per launch in the traced slice, in percent."""

from benchmark.yardstick import kernel_cost, peaks

KERNEL = "factor_prep_kernel"


def read(run):
    times = run.slice.kernels(KERNEL) if run.slice else []
    if not times:
        return None
    s = run.shapes
    least = peaks.least_seconds(*kernel_cost.factor_prep(s["n_train"], s["rank"], s["zdim"]))
    return 100.0 * least / (sum(times) / len(times))
