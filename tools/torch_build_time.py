#!/usr/bin/env python3
"""Time the port's kernel build two ways, from scratch, on a machine with nvcc.

    python3 tools/torch_build_time.py [--rounds 2]

  parallel: what gppvae_tpu_torch/ops/_build.py does, one nvcc per source,
            all started together, then one link;
  single:   one `nvcc -shared` over every source with the same flags.

Each round builds parallel, single, single, parallel, each into a fresh
temporary directory, and prints each build's wall seconds; the last line is
one JSON object with every time and the median of each way. Needs the CUDA
toolkit, not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gppvae_tpu_torch.ops import _build  # noqa: E402


def build_parallel(nvcc: str, lib: Path) -> tuple[bool, str]:
    return _build.compile_library(nvcc, lib)


def build_single(nvcc: str, lib: Path) -> tuple[bool, str]:
    proc = _build.run_nvcc([nvcc, *_build.COMPILE_FLAGS, "-shared", "-o", str(lib),
                            *(str(_build.CSRC / name) for name in _build.SOURCES)])
    return proc.returncode == 0, proc.stdout + proc.stderr


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    nvcc = _build.find_nvcc()
    print(f"nvcc {nvcc}; {os.cpu_count()} CPUs; sources {_build.SOURCES}", flush=True)
    ways = {"parallel": build_parallel, "single": build_single}
    times: dict[str, list[float]] = {w: [] for w in ways}
    for _ in range(args.rounds):
        for way in ("parallel", "single", "single", "parallel"):
            with tempfile.TemporaryDirectory(prefix="build_time_") as tmp:
                t0 = time.perf_counter()
                ok, log = ways[way](nvcc, Path(tmp) / _build.LIB_NAME)
                sec = time.perf_counter() - t0
            if not ok:
                raise RuntimeError(f"{way} build failed:\n{log}")
            times[way].append(sec)
            print(f"{way}: {sec:.3f} s", flush=True)
    print(json.dumps({"times_s": times,
                      "median_s": {w: statistics.median(t) for w, t in times.items()}}))


if __name__ == "__main__":
    main()
