"""bench_torch.py's headline at several training seeds, on the GPU.

    python3 tools/torch_headline_seeds.py [--seeds 0,1,2,3,4,5,6,7] [--parent DIR]

The headline (`gppvae_joint`: GPPVAE-joint on synthetic rotated digits,
5,700 training rows, bfloat16 with the subpixel decoder, 80 epochs, the
first 40 left out of the timing) as bench_torch.py runs it, with the
training seed varied (the data's seed stays 0): the seed moves flax's init,
X₀, the plans and ε, each the JAX package's draw at that seed. DIR, when
given, is another checkout of the port (a `git archive` of an older commit):
each seed then runs in both trees, in turns DIR / this tree for an even
seed and this tree / DIR for an odd one, one process per run, started in
its tree's directory.

Prints one JSON line per run (final oos_mse, its lowest, the median, min
and spread of sec/epoch over the timed epochs, unrounded), then one per
tree: the mean and sample sd of the final oos_mse and of the median
sec/epoch over the seeds. Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run in the tree's own directory: that tree's bench_torch and package
RUN = """
import json, statistics, torch
import bench_torch as b
from gppvae_tpu_torch.train.device import set_float32_precision
set_float32_precision("float32")
spec = b.cut(b.TABLE, **{{b.HEADLINE: dict(train=dict(seed={seed}))}})[b.HEADLINE]
bench = b._Bench(torch.device("cuda"), {{b.HEADLINE: spec}})
bench.record(b.HEADLINE, bench.run(b.HEADLINE))
hist = bench.runs[b.HEADLINE][0].history
secs = [h["sec_epoch"] for h in hist[spec["skip"]:]]
print("RESULT " + json.dumps(dict(
    epochs=len(hist), timed=len(secs), oos_mse=hist[-1]["oos_mse"],
    oos_mse_min=min(h["oos_mse"] for h in hist), median=statistics.median(secs),
    min=min(secs), spread=max(secs) / min(secs))), flush=True)
"""


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def run_in(tree: str, seed: int) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN.format(seed=seed)], cwd=tree,
                         env=dict(os.environ, PYTHONPATH=tree), capture_output=True, text=True,
                         check=False)
    if out.returncode != 0:
        raise RuntimeError(f"seed {seed} in {tree} failed:\n{out.stderr[-3000:]}")
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line.removeprefix("RESULT "))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    p.add_argument("--parent", default=None, help="another checkout of the port")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_headline_seeds.py runs on the GPU; CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    trees = {"this": ROOT, **({"parent": os.path.abspath(args.parent)} if args.parent else {})}
    runs = {name: [] for name in trees}
    for seed in (int(s) for s in args.seeds.split(",")):
        order = list(trees) if seed % 2 else list(trees)[::-1]
        for name in order:
            rec = {"tree": name, "seed": seed, **run_in(trees[name], seed)}
            runs[name].append(rec)
            emit(rec)
    for name, recs in runs.items():
        summary = {"tree": name, "seeds": [r["seed"] for r in recs]}
        for key in ("oos_mse", "median"):
            vals = [r[key] for r in recs]
            summary[key] = {"mean": statistics.fmean(vals),
                            "sd": statistics.stdev(vals) if len(vals) > 1 else None}
        emit(summary)


if __name__ == "__main__":
    main()
