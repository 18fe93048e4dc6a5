"""Where nll_core's time goes on the GPU: per panel, and on the host per call.

    python3 tools/torch_nll_core_steps.py [--reps 20] [--out FILE]

Runs the tree's own package (the checkout this file lies in). Prints JSON
lines, after `nvidia-smi`'s name and power limit:

  1. `steps`, at R = 56, 232, 560 and 2048 (L 16, 32, 16, 8): a second copy of the
     kernel library, built with `GPPVAE_STEP_CLOCK` into the git-ignored
     build directory (`_build.load(("GPPVAE_STEP_CLOCK",))`; the package's
     own build never sets it), records `%globaltimer` on thread 0 of every
     CTA at six points of each panel: its start, step 1 done, the barrier
     after it passed (step 2 starts), step 2 done, the barrier after it
     passed (step 3 starts), steps 3-4 done; the next panel's start is the
     last barrier passed. From CTA 0's stamps, the median over `--reps`
     calls of each panel's step 1, steps 2-4 and barrier waits (µs), their
     sums, and the whole kernel from the first stamp to the last;
  2. `host`, at the main path's shapes (nll_core R 56, L 16; factor_prep
     N 5700, R 56, L 16): one wrapper call cut into its parts, each read
     with time.perf_counter_ns, median over 400 calls (µs), beside the
     median of the whole wrapper call. The parts are those of the tree's
     wrapper: this tree's one ctypes call with its cached plan, or the
     two- and three-call entries of a tree from before the plan (the
     checks, `_build.load()`, `torch.cuda.device(dev)`, the size queries,
     the `torch.empty`s, the stream, the ctypes call).

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
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gppvae_tpu_torch import ops  # noqa: E402
from gppvae_tpu_torch.ops import _build  # noqa: E402
from gppvae_tpu_torch.ops import nll_core as nll_mod  # noqa: E402

# the module: ops re-exports its function under the same name
fp_mod = importlib.import_module("gppvae_tpu_torch.ops.factor_prep")

CLOCK = ("GPPVAE_STEP_CLOCK",)
PANELS_PER_CTA = 512  # the clock buffer's stride per CTA (csrc/nll_core.cu)
MAX_CTAS = 320  # above any driver's CTAs (a grid of two per SM in a tree from before)
STEP_SHAPES = [(5700, 56, 16), (332, 232, 32), (5700, 560, 16), (6400, 2048, 8)]
HOST_REPS = 400


def emit(out, rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def inputs(n: int, r: int, l: int, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
    Z = torch.randn(n, l, device="cuda", generator=gen)
    G, UtZ, zn = ops.factor_prep_torch(U, Z)
    return U, Z, G, UtZ, zn, torch.tensor(0.37, device="cuda")


def step_split(n: int, r: int, l: int, reps: int) -> dict:
    """Each panel's step 1, steps 2-4 and barrier waits (µs, median over
    reps) from the step-clock build's stamps."""
    clock_lib = _build.load(CLOCK)
    clock_lib.gppvae_nll_core_clock.argtypes = [ctypes.c_void_p]
    clock_lib.gppvae_nll_core_clock.restype = ctypes.c_int
    # a tree from before the lookahead stamps six points per panel, this one eight
    stamps = (clock_lib.gppvae_nll_core_stamps()
              if hasattr(clock_lib, "gppvae_nll_core_stamps") else 6)
    _, _, G, UtZ, zn, vn = inputs(n, r, l)
    buf = torch.zeros(MAX_CTAS * PANELS_PER_CTA * stamps, dtype=torch.int64, device="cuda")
    main_load = _build.load
    _build.load = lambda defines=(): main_load(CLOCK)  # the wrappers launch the clock build
    try:
        ops.launch_nll_core(G, UtZ, zn, vn, n, l)  # warm up, clock off
        drivers = dict(getattr(ops.launch_nll_core, "drivers", {}))
        _build.check(clock_lib.gppvae_nll_core_clock(buf.data_ptr()), "step clock")
        rows = []
        for _ in range(reps):
            buf.zero_()
            ops.launch_nll_core(G, UtZ, zn, vn, n, l)
            torch.cuda.synchronize()
            rows.append(buf.view(MAX_CTAS, PANELS_PER_CTA, stamps).cpu())
        _build.check(clock_lib.gppvae_nll_core_clock(None), "step clock")
    finally:
        _build.load = main_load
    panels = int((rows[0][0, :, 5] != 0).sum())
    keys = ("step1", "d_copy", "steps2_4", "barriers", "panel")
    sub = ("step1_load", "step1_factor", "step1_invert", "step1_write")
    per = {k: [] for k in keys + sub}
    for p in range(panels):
        vals = {k: [] for k in keys + sub}
        cta = -1
        for t in rows:
            t0, t1, t2, t3, t4, t5 = (int(v) for v in t[0, p, :6])
            nxt = int(t[0, p + 1, 0])
            s24 = (t3 - t2) + (t5 - t4)
            wait = (t2 - t1) + (t4 - t3) + (nxt - t5)
            if stamps == 6:  # step 1 on the critical path, before the first barrier
                s1, copy = t1 - t0, 0
            else:  # the lookahead: panel p+1's factorization, on the CTA that ran it
                ran = (t[:, p, 6] != 0).nonzero()
                cta = int(ran[0]) if len(ran) else -1
                s1 = int(t[cta, p, 7] - t[cta, p, 6]) if cta >= 0 else 0
                copy = t1 - t0
                if cta == 0:  # CTA 0's step 3 window held the factorization
                    s24 -= s1
            for k, v in zip(keys, (s1, copy, s24, wait, nxt - t0)):
                vals[k].append(v / 1e3)
            if stamps > 8 and cta >= 0:  # inside the factorization
                t6, t7, t8, t9, t10 = (int(t[cta, p, i]) for i in (6, 7, 8, 9, 10))
                for k, v in zip(sub, (t8 - t6, t9 - t8, t10 - t9, t7 - t10)):
                    vals[k].append(v / 1e3)
        for k in keys + sub:
            if vals[k]:
                per[k].append(statistics.median(vals[k]))
    total = statistics.median((int(t[0, panels, 0]) - int(t[0, 0, 0])) / 1e3 for t in rows)
    alone = None  # the first block's factorization, before any other work
    if stamps > 8:
        first = [int(t[:, PANELS_PER_CTA - 1, 7].max() - t[:, PANELS_PER_CTA - 1, 6].max())
                 for t in rows]
        alone = statistics.median(first) / 1e3
    return {"kind": "steps", "shape": [n, r, l], "stamps": stamps, "panels": panels,
            "kernel_us": total, "step1_alone_us": alone,
            **{f"{k}_us_sum": sum(v) for k, v in per.items()},
            "per_panel_us": {k: [round(x, 3) for x in v] for k, v in per.items()},
            "drivers": drivers or None}


def median_parts(parts: list[tuple[str, object]], reps: int) -> dict:
    """Run the parts in order `reps` times, each timed; the median µs of each."""
    times = {name: [] for name, _ in parts}
    for _ in range(reps):
        state: dict = {}
        for name, fn in parts:
            t0 = time.perf_counter_ns()
            fn(state)
            times[name].append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return {name: statistics.median(v) / 1e3 for name, v in times.items()}


def whole_us(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def nll_parts(G, UtZ, zn, vn, n: int, l: int) -> list:
    R, L = G.shape[0], UtZ.shape[1]
    dev = G.device
    if hasattr(nll_mod, "plan_nll_core"):  # one ctypes call with a cached plan
        return [
            ("checks", lambda s: nll_mod._check_nll_core(G, UtZ, zn, vn)),
            ("load", lambda s: s.update(lib=_build.load())),
            ("device", lambda s: s.update(ctx=nll_mod._on(dev)) or s["ctx"].__enter__()),
            ("plan", lambda s: s.update(plan=nll_mod._plan(dev.index, R, L))),
            ("empty", lambda s: s.update(out=nll_mod._outputs(dev, R, L, s["plan"]))),
            ("stream", lambda s: s.update(stream=fp_mod._stream(dev))),
            ("ctypes", lambda s: s.update(err=nll_mod._launch(
                s["lib"], s["plan"], G, UtZ, zn, vn, *s["out"], n, l, s["stream"]))),
            ("exit", lambda s: s["ctx"].__exit__(None, None, None)),
            ("check", lambda s: _build.check(s["err"], "nll_core kernel")),
        ]
    # the tree from before the plan: a size query, then the launch
    return [
        ("checks", lambda s: fp_mod._check_cuda_f32(G, UtZ, zn, vn)),
        ("load", lambda s: s.update(lib=_build.load())),
        ("device", lambda s: s.update(ctx=torch.cuda.device(dev)) or s["ctx"].__enter__()),
        ("size_query", lambda s: s.update(n=s["lib"].gppvae_nll_core_scratch(R, L))),
        ("empty", lambda s: s.update(
            scratch=torch.empty(s["n"], device=dev) if s["n"] else None,
            nll=torch.empty((), device=dev), X=torch.empty((R, R), device=dev),
            W=torch.empty((R, L), device=dev))),
        ("stream", lambda s: s.update(stream=torch.cuda.current_stream(dev).cuda_stream)),
        ("ctypes", lambda s: s.update(err=s["lib"].gppvae_nll_core(
            G.data_ptr(), UtZ.data_ptr(), zn.data_ptr(), vn.data_ptr(), s["nll"].data_ptr(),
            s["X"].data_ptr(), s["W"].data_ptr(),
            None if s["scratch"] is None else s["scratch"].data_ptr(),
            R, L, n, l, s["stream"]))),
        ("exit", lambda s: s["ctx"].__exit__(None, None, None)),
        ("check", lambda s: _build.check(s["err"], "nll_core kernel")),
    ]


def fp_parts(U, Z) -> list:
    (N, R), L = U.shape, Z.shape[1]
    dev = U.device
    if hasattr(fp_mod, "plan_factor_prep"):
        return [
            ("checks", lambda s: fp_mod._check_factor_prep(U, Z)),
            ("load", lambda s: s.update(lib=_build.load())),
            ("device", lambda s: s.update(ctx=fp_mod._on(dev)) or s["ctx"].__enter__()),
            ("plan", lambda s: s.update(plan=fp_mod._plan(dev.index, N, R, L))),
            ("stream", lambda s: s.update(stream=fp_mod._stream(dev))),
            ("scratch", lambda s: s.update(ws=fp_mod._scratch(dev, s["stream"], s["plan"]))),
            ("empty", lambda s: s.update(out=fp_mod._outputs(dev, R, L))),
            ("ctypes", lambda s: s.update(err=fp_mod._launch(
                s["lib"], s["plan"], U, Z, *s["out"], *s["ws"], s["stream"]))),
            ("exit", lambda s: s["ctx"].__exit__(None, None, None)),
            ("check", lambda s: _build.check(s["err"], "factor_prep kernel")),
        ]
    return [
        ("checks", lambda s: fp_mod._check_cuda_f32(U, Z)),
        ("load", lambda s: s.update(lib=_build.load())),
        ("device", lambda s: s.update(ctx=torch.cuda.device(dev)) or s["ctx"].__enter__()),
        ("stream", lambda s: s.update(stream=torch.cuda.current_stream(dev).cuda_stream)),
        ("size_query", lambda s: s.update(ws=fp_mod._scratch(s["lib"], dev, s["stream"],
                                                             N, R, L))),
        ("empty", lambda s: s.update(G=torch.empty((R, R), device=dev),
                                     UtZ=torch.empty((R, L), device=dev),
                                     zn=torch.empty((), device=dev))),
        ("ctypes", lambda s: s.update(err=s["lib"].gppvae_factor_prep(
            U.data_ptr(), Z.data_ptr(), s["G"].data_ptr(), s["UtZ"].data_ptr(),
            s["zn"].data_ptr(), s["ws"][0].data_ptr(), s["ws"][1].data_ptr(), N, R, L,
            s["stream"]))),
        ("exit", lambda s: s["ctx"].__exit__(None, None, None)),
        ("check", lambda s: _build.check(s["err"], "factor_prep kernel")),
    ]


def host_split() -> list[dict]:
    n, r, l = 5700, 56, 16
    U, Z, G, UtZ, zn, vn = inputs(n, r, l)
    out = []
    for name, parts, call in (
            ("nll_core", nll_parts(G, UtZ, zn, vn, n, l),
             lambda: ops.launch_nll_core(G, UtZ, zn, vn, n, l)),
            ("factor_prep", fp_parts(U, Z), lambda: ops.launch_factor_prep(U, Z))):
        with ops.uncounted():
            call()
            split = median_parts(parts, HOST_REPS)
            whole = whole_us(call, HOST_REPS)
        out.append({"kind": "host", "kernel": name, "shape": [n, r, l], "parts_us": split,
                    "parts_sum_us": sum(split.values()), "wrapper_us": whole})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/torch_nll_core_steps.py needs CUDA")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = open(args.out, "a") if args.out else None
    emit(out, {"kind": "card", "tree": ROOT, "nvidia_smi": smi.stdout.strip(),
               "torch": torch.__version__, "cuda": torch.version.cuda})
    for shape in STEP_SHAPES:
        emit(out, step_split(*shape, args.reps))
    for rec in host_split():
        emit(out, rec)


if __name__ == "__main__":
    main()
