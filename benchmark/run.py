#!/usr/bin/env python3
"""Run one cell of the benchmark of gppvae_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`. The run makes its
inputs and initial weights from --seed, sets up the program and warms every
shape the cell uses (set-up), measures for --seconds, then, with --trace 1,
profiles a fixed slice of further work. Once the program's state is freed it
compares what the timed path produced with the plain reference
(benchmark/reference/) and decides `correct`.

Its last line on standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and last
`checks`, each compared number beside its limit; the same numbers are the
last lines on standard error. Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits 2. If JAX, flax or the JAX
package is loaded when the window has closed it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# a fixed cache inside the checkout for any Triton kernel the program may build
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "gppvae_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(manifest, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float = T_START, fault=None) -> dict:
    """One run of cell `name` on `device`; the result line's dict. `fault`,
    a function of harness/faults.py, is planted under the timed path (for
    calibrate.py and the tests)."""
    from benchmark.harness import cells, checks

    cell = manifest.workload(name)
    cfg, mix = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    run = cells.Run(cell, cfg, mix, device, seed)
    run.card_slice = any(m["source"] == "device_trace" for m in manifest.metrics(name, traced))
    cells.KINDS[mix["kind"]](run, seconds, traced, t_start, fault)
    correct, table = checks.judge(run.numbers, manifest.limits(name))
    metrics = {}
    for m in manifest.metrics(name, traced):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": _device(device, run, traced)}
    if traced and run.slice is not None:
        out["breakdown"] = {"device_ops": run.slice.device_ops(),
                            "idle_gaps": run.host_slice.idle_gaps()}
    out["checks"] = table
    out["not_compared"] = {k: v for k, v in run.numbers.items() if k not in table}
    out["setup_parts"] = run.setup_parts
    out["reference_s"] = run.reference_s
    out["units_s"] = [e["wall_s"] for e in run.epochs] or _quartiles(run.latencies)
    return out


def _quartiles(values: list) -> list:
    import statistics

    return statistics.quantiles(values, n=4) if len(values) > 1 else values


def _device(device, run, traced: bool) -> dict:
    import torch

    gpu = device.type == "cuda"
    out = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
           "count": run.cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    if traced and run.slice is not None:
        out["busy_s"] = run.slice.busy_s()
        out["window_s"] = run.slice.wall_s
    return out


def _card() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return smi.stdout.strip() or smi.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {type(e).__name__}: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.manifest import Manifest
    from benchmark.yardstick import peaks

    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload!r} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"# card (name, power limit): {_card()}")
    print(f"# peaks: bf16 {peaks.BF16_FLOPS:.4g} FLOP/s, TF32 {peaks.TF32_FLOPS:.4g} FLOP/s, "
          f"split TF32 {peaks.SPLIT_TF32_FLOPS:.4g} FLOP/s, fp32 {peaks.FP32_FLOPS:.4g} FLOP/s, "
          f"HBM {peaks.HBM_BYTES_PER_S:.4g} B/s")
    print(f"# set-up by part (s): {json.dumps(out.pop('setup_parts'))}")
    print(f"# the reference's seconds, after the window: {out.pop('reference_s')}")
    print(f"# window: each epoch's seconds, or the requests' latency quartiles: "
          f"{json.dumps(out.pop('units_s'))}")
    print(f"# read, not compared: {json.dumps(out.pop('not_compared'))}")
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
