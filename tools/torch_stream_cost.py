"""What drawing the JAX package's random stream costs the port's training, on the GPU.

    python3 tools/torch_stream_cost.py --parent DIR [--rounds 1]

DIR is a checkout of the port from before it drew the JAX package's stream
(its draws came from a torch.Generator). Prints JSON lines:

  1. `draws`: the host time of one epoch's draws at the slice's shapes (the
     plan over 5,700 rows and the ε of 45 steps of 128 × 16), median and
     max over 20 epochs: this tree's (utils/prng.py through
     train/batching.make_draws, numpy on the host) beside the generator's
     draws of the same shapes (torch.randperm + torch.randn);
  2. `in_training`: the same draws timed inside a 20-epoch
     gppvae_joint_f32 run on this tree (the trainer's own make_draws,
     wrapped), per epoch, beside the run's sec/epoch: their share;
  3. `bench`: bench_torch.py's headline (gppvae_joint, bf16 + subpixel, 80
     epochs) and gppvae_joint_f32 (30 epochs), each one process per tree
     in turns, DIR / this tree / this tree / DIR (× --rounds): the median,
     min and spread of sec/epoch over the bench's timed epochs, unrounded.

Needs CUDA; `nvidia-smi`'s name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = ("gppvae_joint_f32", "gppvae_joint")
DEVICE = "cuda"
# run in the tree's own directory: that tree's bench_torch and package
BENCH = """
import json, statistics, sys, torch
import bench_torch as b
from gppvae_tpu_torch.train.device import set_float32_precision
set_float32_precision("float32")
table = {{n: b.TABLE[n] for n in {configs!r}}}
bench = b._Bench(torch.device({device!r}), table)
out = {{}}
for name, spec in table.items():
    bench.record(name, bench.run(name))
    secs = [h["sec_epoch"] for h in bench.runs[name][0].history[spec["skip"]:]]
    out[name] = dict(median=statistics.median(secs), min=min(secs),
                     spread=max(secs) / min(secs), epochs=len(secs),
                     oos_mse=bench.runs[name][0].history[-1]["oos_mse"])
print("RESULT " + json.dumps(out), flush=True)
"""


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def draw_times(n: int = 5700, bs: int = 128, zdim: int = 16, epochs: int = 20) -> dict:
    from gppvae_tpu_torch.train import batching
    from gppvae_tpu_torch.utils import prng

    draws = batching.make_draws(prng.PRNGKey(0), n, bs, zdim)
    nb = batching.num_batches(n, bs)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, fn in (("jax_stream", draws),
                     ("torch_generator", lambda e: (torch.randperm(n, generator=gen),
                                                     torch.randn((nb, bs, zdim), generator=gen)))):
        fn(0)
        ms = []
        for e in range(1, epochs + 1):
            t0 = time.perf_counter()
            fn(e)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"median_ms": statistics.median(ms), "max_ms": max(ms)}
    return out


def in_training(epochs: int = 20) -> dict:
    """The trainer's draws per epoch of a gppvae_joint_f32 run (bench_torch's
    config, this tree), timed where the trainer calls them."""
    import bench_torch as b
    from gppvae_tpu_torch.train import train_gppvae

    ms = []
    own = train_gppvae.make_draws

    def timed(*args, **kwargs):
        draws = own(*args, **kwargs)

        def call(epoch):
            t0 = time.perf_counter()
            try:
                return draws(epoch)
            finally:
                ms.append((time.perf_counter() - t0) * 1e3)
        return call

    spec = b.cut(b.TABLE, gppvae_joint_f32=dict(train=dict(epochs=epochs)))
    train_gppvae.make_draws = timed
    try:
        bench = b._Bench(torch.device(DEVICE), {"gppvae_joint_f32": spec["gppvae_joint_f32"]})
        bench.record("gppvae_joint_f32", bench.run("gppvae_joint_f32"))
    finally:
        train_gppvae.make_draws = own
    sec = statistics.median(h["sec_epoch"] for h in bench.runs["gppvae_joint_f32"][0].history[1:])
    return {"epochs": len(ms), "first_ms": ms[0], "later_median_ms": statistics.median(ms[1:]),
            "later_max_ms": max(ms[1:]), "sec_epoch_median": sec,
            "share": statistics.median(ms[1:]) / 1e3 / sec}


def bench_in(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", BENCH.format(configs=CONFIGS, device=DEVICE)], cwd=tree,
                         capture_output=True, text=True, check=True)
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="the tree before the JAX stream")
    p.add_argument("--rounds", type=int, default=1, help="rounds of parent/this/this/parent")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_stream_cost.py measures the GPU; CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    emit({"draws": draw_times()})
    emit({"in_training": in_training()})
    runs = {"parent": [], "this": []}
    for _ in range(args.rounds):
        for which in ("parent", "this", "this", "parent"):
            tree = os.path.abspath(args.parent) if which == "parent" else ROOT
            res = bench_in(tree)
            runs[which].append(res)
            emit({"bench": which, **res})
    emit({"summary": {name: {which: [r[name]["median"] for r in rs]
                             for which, rs in runs.items()} for name in CONFIGS}})


if __name__ == "__main__":
    main()
