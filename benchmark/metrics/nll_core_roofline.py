"""nll_core_roofline: the least time of one NLL-core launch at the cell's
(R, L) (yardstick/kernel_cost.py, yardstick/peaks.py) over the kernel's mean
device time per launch in the traced slice, in percent. The core runs as
one of two kernels, `nll_core_dist` or `nll_core_grid`."""

from benchmark.yardstick import kernel_cost, peaks

KERNEL = "nll_core_"


def read(run):
    times = run.slice.kernels(KERNEL) if run.slice else []
    if not times:
        return None
    s = run.shapes
    least = peaks.least_seconds(*kernel_cost.nll_core(s["rank"], s["zdim"]))
    return 100.0 * least / (sum(times) / len(times))
