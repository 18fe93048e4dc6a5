"""nll_core's three drivers side by side on the GPU, at any R.

    python3 tools/torch_nll_core_drivers.py [--r 56,128,232,560,2048] [--l 16]
        [--drivers cta,cluster,grid] [--clusters 4,8,16] [--reps 50]

For each R and each driver that can run it (a forced plan,
ops.nll_core.plan_nll_core(..., driver=, cluster=); the cta driver only
where its shared memory fits, the cluster at its default size and at each
of --clusters), one JSON line: the plan, the value against the plain
version (relative error), X and W's max abs error, whether a rerun is bit
for bit the same, and two times of the launch alone: `ms`, the median of
CUDA events around one launch (after 5; with the host's enqueue where that
is longer), and `device_ms`, the kernel's own device time per launch
(utils/kernel_timing.device_ms: CUDA events around 50 launches queued
behind a sleep). The cut-overs of plan_nll_core (CTA_MAX_R) came from these
times, read then from torch.profiler's kernel times. G, UᵀZ come from 6,400 random rows (N(0, 1/R) and N(0, 1)),
vₙ = 0.37, as in chip_smoke.py's phase 3. Needs CUDA; prints `nvidia-smi`'s
name and power limit and the device's properties first.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gppvae_tpu_torch import ops  # noqa: E402
from gppvae_tpu_torch.ops import _build  # noqa: E402
from gppvae_tpu_torch.ops import nll_core as nll_mod  # noqa: E402
from gppvae_tpu_torch.utils.kernel_timing import device_ms  # noqa: E402

N_ROWS = 6400


def ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def launch_ms(fn, reps: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(R: int, L: int, plan, reps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(R)
    U = torch.randn(N_ROWS, R, device="cuda", generator=gen) / math.sqrt(R)
    Z = torch.randn(N_ROWS, L, device="cuda", generator=gen)
    G, UtZ, zn = ops.factor_prep_torch(U, Z)
    vn = torch.tensor(0.37, device="cuda")
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        out = nll_mod._outputs(G.device, R, L, plan)
        _build.check(nll_mod._launch(lib, plan, G, UtZ, zn, vn, *out, N_ROWS, L, stream),
                     f"nll_core {plan}")
        return out[:3]

    got, again = launch(), launch()
    want = ops.nll_core_torch(G, UtZ, zn, vn, N_ROWS, L)
    torch.cuda.synchronize()
    rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    xw = max(float((a - b).abs().max()) for a, b in zip(got[1:], want[1:]))
    return {"R": R, "L": L, "driver": plan.driver, "ctas": plan.ctas, "smem": plan.smem,
            "value_rel": rel, "xw_max_abs": xw, "finite": bool(torch.isfinite(got[1]).all()),
            "same": all(torch.equal(a, b) for a, b in zip(got, again)),
            "ms": launch_ms(launch, reps), "device_ms": device_ms(launch, reps)[0]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--r", type=ints, default=ints("56,128,232,560,2048"))
    ap.add_argument("--l", type=int, default=16)
    ap.add_argument("--drivers", default="cta,cluster,grid")
    ap.add_argument("--clusters", type=ints, default=[])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/torch_nll_core_drivers.py needs CUDA")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    props = _build.device_props(torch.cuda.current_device())
    print(json.dumps({"nvidia_smi": smi.stdout.strip(), "props": props}), flush=True)
    for R in args.r:
        plans = []
        for driver in args.drivers.split(","):
            sizes = [None, *args.clusters] if driver == "cluster" else [None]
            for size in sizes:
                try:
                    plan = nll_mod.plan_nll_core(R, args.l, props, driver=driver, cluster=size)
                except ValueError as e:  # this driver cannot take R: say so, go on
                    print(json.dumps({"R": R, "driver": driver, "cluster": size,
                                      "skipped": str(e)}), flush=True)
                    continue
                if plan not in plans:
                    plans.append(plan)
        for plan in plans:
            print(json.dumps(run(R, args.l, plan, args.reps)), flush=True)


if __name__ == "__main__":
    main()
