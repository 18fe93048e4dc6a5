#!/usr/bin/env python3
"""The readings that a cell's limits are set from (limits/<cell>.json).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 3] [--faults 3] [--seconds 2] [--out FILE]

For each seed, in one process on the card: a run of the cell as run.py makes
it, with a short window (the compared numbers come from set-up's checked
epoch, or from the window's kept replies), and its numbers against the
reference: the program's readings, whose largest is a limit's lower end.
On the first --control seeds, the same numbers of the configuration's
control, the reference computed one precision step below what the
configuration states, put in the program's place; and on the first --faults
seeds, of each fault of harness/faults.py planted under the timed path. The
smallest of those that reads three times the lower end or more is the upper
end. Prints one JSON line per reading, then a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(manifest, name: str, seed: int, seconds: float, device, fault=None,
             control: str | None = None):
    """[(kind, numbers)] of one seed: the program's (or, with `fault`, the
    faulty program's) and, with `control`, the control's."""
    from benchmark.harness import cells, checks, faults

    cell = manifest.workload(name)
    cfg, mix = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    run = cells.Run(cell, cfg, mix, device, seed)
    plant = {**faults.TRAINING, **faults.SERVING}[fault] if fault else None
    cells.KINDS[mix["kind"]](run, seconds, False, time.perf_counter(), plant)
    out = [(fault or "program", run.numbers)]
    if control:
        number = checks.training_numbers if mix["kind"] == "train" else checks.serving_numbers
        out.append((f"control:{control}", number(cells.reference(run, control), run.ref)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--faults", type=int, default=3, help="seeds that also read each fault")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import faults
    from benchmark.harness.manifest import Manifest

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = Manifest()
    cell = manifest.workload(args.workload)
    cfg, mix = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    # a state left unchanged reads 1 by construction (checks.update_gap)
    kinds = [f for f in (faults.TRAINING if mix["kind"] == "train" else faults.SERVING)
             if f != "frozen_state"]
    rows = []
    sink = open(args.out, "w") if args.out else None
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            todo = [(None, cfg["control"] if i < args.control else None)]
            todo += [(f, None) for f in kinds if i < args.faults]
            for fault, control in todo:
                t0 = time.perf_counter()
                for kind, numbers in readings(manifest, args.workload, seed, args.seconds,
                                              device, fault, control):
                    row = {"cell": args.workload, "seed": seed, "kind": kind,
                           "numbers": numbers, "s": time.perf_counter() - t0}
                    rows.append(row)
                    line = json.dumps(row)
                    print(line, flush=True)
                    if sink:
                        print(line, file=sink, flush=True)
    finally:
        if sink:
            sink.close()
    summary = {}
    for row in rows:
        for k, v in row["numbers"].items():
            entry = summary.setdefault(k, {})
            agg = max if row["kind"] == "program" else min
            entry[row["kind"]] = agg(entry.get(row["kind"], v), v)
    print(json.dumps({"cell": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
