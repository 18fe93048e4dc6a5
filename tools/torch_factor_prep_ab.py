"""factor_prep's device time and accuracy at the paths' shapes, in one tree.

    python3 tools/torch_factor_prep_ab.py [--tag NAME] [--reps 3] [--out FILE]

Runs the package of the tree it lies in: to compare two kernels in one
call, copy this file and utils/kernel_timing.py into the other tree and
run both in turns (parent, change, change, parent). Prints `nvidia-smi`'s
name and power limit, then one JSON line per shape (the paths' shapes of
chip_smoke.py's phase 3 and the bench's N 262,144 at R 256 and 512):

  * `queued_ms`: `--reps` readings of kernel_timing.queued_ms (CUDA events
    around 50 launches queued behind torch.cuda._sleep), and their median;
  * per output (G, UtZ, zn), max abs error over max |·| of the kernel and of
    the float32 plain version against the plain version in float64, and of
    the kernel against the float32 plain version; and the mean signed
    relative error of G's diagonal (a sum of positive terms, where a sum
    that rounds toward zero shows as a negative mean).

Inputs: U ~ N(0, 1/R), Z ~ N(0, 1) from torch.Generator(cuda) seed 0;
TF32 off. Needs CUDA.
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
from gppvae_tpu_torch.utils.kernel_timing import queued_ms  # noqa: E402

SHAPES = [(5700, 56, 16), (5701, 56, 16), (2850, 56, 16), (332, 232, 32), (5700, 560, 16),
          (256, 2048, 8), (6401, 256, 16), (262144, 256, 16), (262144, 512, 16)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b).abs().max() / b.abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default=ROOT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/torch_factor_prep_ab.py needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = open(args.out, "a") if args.out else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i, (n, r, l) in enumerate(SHAPES):
        U = torch.randn(n, r, device="cuda", generator=gen) / math.sqrt(r)
        Z = torch.randn(n, l, device="cuda", generator=gen)
        with ops.uncounted():
            times = [queued_ms(lambda: ops.launch_factor_prep(U, Z)) for _ in range(args.reps)]
            k = ops.launch_factor_prep(U, Z)
        p = ops.factor_prep_torch(U, Z)
        d = ops.factor_prep_torch(U.double(), Z.double())
        diag = torch.diagonal(d[0])
        rec = {"tag": args.tag, "shape": [n, r, l], "queued_ms": times,
               "median_ms": statistics.median(times),
               "errors": {name: {"kernel_vs_f64": rel(k[j], d[j]), "plain_vs_f64": rel(p[j], d[j]),
                                 "kernel_vs_plain": rel(k[j], p[j].double())}
                          for j, name in enumerate(("G", "UtZ", "zn"))},
               "G_diag_mean_signed_rel": {
                   "kernel": float(((torch.diagonal(k[0]).double() - diag) / diag).mean()),
                   "plain": float(((torch.diagonal(p[0]).double() - diag) / diag).mean())}}
        if i == 0:
            rec["nvidia_smi"] = smi.stdout.strip()
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
