"""Where factor_prep's time goes on the GPU: one call, cut into its steps.

    python3 tools/torch_factor_prep_steps.py [--reps 20] [--shapes N,R,L;...]
        [--force bt=64,cluster=8,chunks=16] [--out FILE]

The twin of tools/torch_nll_core_steps.py. Runs the tree's own package (the
checkout this file lies in): copy it into another tree with the same
step-clock hooks to compare two kernels in one call. Prints JSON lines,
after `nvidia-smi`'s name and power limit, one per shape (default: the main
path's N 5700, R 56, L 16 and the bench's N 262144, R 256, L 16):

  a second copy of the kernel library, built with `GPPVAE_STEP_CLOCK` into
  the git-ignored build directory (`_build.load(("GPPVAE_STEP_CLOCK",))`;
  the package's own build never sets it), records `%globaltimer` on thread
  0 of every CTA at eight points: 0 the CTA starts, 1 its first stage is in
  shared memory, 2 its last stage is consumed, 3 its partial sums are
  written, 4 its cluster's partials are summed (a kernel without clusters
  stamps 3 again), 5 it has taken its ticket, 6 the CTA that drew the last
  ticket has summed the partials, 7 the CTA has stored its outputs (a CTA
  with nothing to store stamps neither 6 nor 7). From these, the median
  over `--reps` calls of:
    * `kernel_us`: the first CTA's start to the last stamp of any CTA;
    * `launch_spread_us`: the first CTA's start to the last CTA's start;
    * `per_cta_us`: each step's median over the CTAs (first stage, stages,
      partial, cluster, ticket) and over the CTAs that summed (last sum,
      store);
    * `critical_us`: the same steps of the CTA whose last stamp is the
      kernel's last, from the first CTA's start (`start_offset`).
  `--force` runs the plan that ops.factor_prep.make_plan builds from bt
  (default: the plan's tile edge for R), cluster (1) and chunks (the
  cluster) in place of plan_factor_prep's. Beside them the call's device
  time from the package's own build: `queued_ms` (CUDA events around 50
  launches queued behind torch.cuda._sleep, utils/kernel_timing.queued_ms)
  and `profiler_ms` (torch.profiler's kernel time per call,
  kernel_timing.profiled_ms, and `profiler_kernels`, how many of its 50
  launches it recorded).

Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
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
from gppvae_tpu_torch.utils import kernel_timing as kt  # noqa: E402

fp_mod = importlib.import_module("gppvae_tpu_torch.ops.factor_prep")  # ops.factor_prep: the function

CLOCK = ("GPPVAE_STEP_CLOCK",)
MAX_STAMPS = 9  # per CTA (csrc/factor_prep.cu; a kernel from before the ring wait: 8)
MAX_CTAS = 8192
SHAPES = [(5700, 56, 16), (262144, 256, 16)]
STEPS = ("first_stage", "stages", "ring_wait", "partial", "cluster", "ticket", "last_sum",
         "store")


def emit(out, rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def cta_steps(s: list[int]) -> dict:
    """One CTA's steps (ns) from its eight stamps; a step it did not take is
    absent."""
    t = dict(enumerate(s))
    out = {"first_stage": t[1] - t[0], "stages": t[2] - t[1]}
    if len(s) > 8:
        out["ring_wait"] = t[8]
    if t[3]:
        out["partial"] = t[3] - t[2]
    if t[4] and t[3]:
        out["cluster"] = t[4] - t[3]
    if t[5]:
        out["ticket"] = t[5] - t[4]
    if t[6]:
        out["last_sum"] = t[6] - t[5]
    if t[7]:
        out["store"] = t[7] - (t[6] or t[4] or t[2])
    return out


def one_call(rows: torch.Tensor) -> dict:
    """The call's split (ns) from the stamps of its CTAs (rows: CTAs × 8)."""
    t0 = int(rows[:, 0].min())
    ends = rows[:, :8].max(dim=1).values
    last = int(ends.argmax())
    steps = [cta_steps([int(v) for v in row]) for row in rows]
    per = {k: statistics.median(s[k] for s in steps if k in s) for k in STEPS
           if any(k in s for s in steps)}
    crit = {"start_offset": int(rows[last, 0]) - t0, **steps[last]}
    return {"kernel": int(ends.max()) - t0, "launch_spread": int(rows[:, 0].max()) - t0,
            "per_cta": per, "critical": crit}


def median_of(calls: list[dict], key: str) -> dict:
    keys = {k for c in calls for k in c[key]}
    return {k: round(statistics.median(c[key][k] for c in calls if k in c[key]) / 1e3, 3)
            for k in sorted(keys)}


def step_split(n: int, r: int, l: int, reps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    call = lambda: ops.launch_factor_prep(U, Z)  # noqa: E731
    with ops.uncounted():
        queued = kt.queued_ms(call)
        profiled, recorded = kt.profiled_ms(call)
        clock_lib = _build.load(CLOCK)
        clock_lib.gppvae_factor_prep_clock.argtypes = [ctypes.c_void_p]
        clock_lib.gppvae_factor_prep_clock.restype = ctypes.c_int
        stamps = (clock_lib.gppvae_factor_prep_stamps()
                  if hasattr(clock_lib, "gppvae_factor_prep_stamps") else 8)
        buf = torch.zeros(MAX_CTAS * stamps, dtype=torch.int64, device="cuda")
        main_load = _build.load
        _build.load = lambda defines=(): main_load(CLOCK)  # the wrapper launches the clock build
        try:
            call()  # warm up, clock off
            _build.check(clock_lib.gppvae_factor_prep_clock(buf.data_ptr()), "step clock")
            calls = []
            for _ in range(reps):
                buf.zero_()
                call()
                torch.cuda.synchronize()
                rows = buf.view(MAX_CTAS, stamps).cpu()
                calls.append(one_call(rows[rows[:, 0] != 0]))
            ctas = int((rows[:, 0] != 0).sum())
            _build.check(clock_lib.gppvae_factor_prep_clock(None), "step clock")
        finally:
            _build.load = main_load
    extra = (fp_mod._aligned(U, Z),) if hasattr(fp_mod, "_aligned") else ()
    plan = fp_mod._plan(U.device.index, n, r, l, *extra)
    return {"kind": "steps", "shape": [n, r, l], "ctas": ctas, "reps": reps,
            "plan": {k: v for k, v in plan.__dict__.items() if k in (
                "bt", "tiles", "cluster", "chunks", "rows_per_chunk", "copy", "tm", "tn")},
            "kernel_us": round(statistics.median(c["kernel"] for c in calls) / 1e3, 3),
            "launch_spread_us": round(statistics.median(c["launch_spread"] for c in calls) / 1e3, 3),
            "per_cta_us": median_of(calls, "per_cta"), "critical_us": median_of(calls, "critical"),
            "queued_ms": queued, "profiler_ms": profiled, "profiler_kernels": recorded}


def parse_shapes(text: str) -> list[tuple[int, int, int]]:
    return [tuple(int(v) for v in s.split(",")) for s in text.split(";") if s]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", type=parse_shapes, default=SHAPES,
                    help="N,R,L;N,R,L;... (default: the main path's and the bench's R 256)")
    ap.add_argument("--force", default="", help="make_plan's bt, cluster, chunks")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if args.force:
        force = {k: int(v) for k, v in (kv.split("=") for kv in args.force.split(","))}
        bt, cluster = force.get("bt"), force.get("cluster", 1)
        fp_mod._plan = lambda index, n, r, l, aligned=True: fp_mod.make_plan(
            n, r, l, bt or fp_mod.tile_edge(r), cluster, force.get("chunks", cluster), aligned)
    if not torch.cuda.is_available():
        raise SystemExit("tools/torch_factor_prep_steps.py needs CUDA")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = open(args.out, "a") if args.out else None
    emit(out, {"kind": "card", "tree": ROOT, "nvidia_smi": smi.stdout.strip(),
               "torch": torch.__version__, "cuda": torch.version.cuda, "force": args.force})
    for shape in args.shapes:
        emit(out, step_split(*shape, args.reps))


if __name__ == "__main__":
    main()
