"""The headline configuration trained by both packages from one seed, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_headline_parity.py --seed 0 --epochs 6 \
        [--parent DIR]

bench.py's `gppvae_joint`, config 3b (the headline: GPPVAE-joint on synthetic
rotated digits, 400 objects × 16 views, 5,700 training rows, 32×32, zdim
16, R = 56, bs 128, bfloat16 compute with the subpixel decoder, no float32
polish) at the published widths and a depth of --epochs, trained by the
JAX package (`gppvae_tpu.train.train_gppvae`) and by the port
(`gppvae_tpu_torch`) from the same --seed: the same flax init, X₀, plans
and ε (the port draws the JAX package's stream). DIR, when given, is
another checkout of the port (a `git archive` of an older commit); its
run goes beside this tree's.

Prints, one JSON line each: every epoch's `loss` and `oos_mse` side by
side, then the final gap (|port − jax| / jax of the last epoch's loss and
oos_mse, and the largest over the epochs). Each port runs in a process of
its own, started in its tree's directory. It needs jax, so it runs where
the JAX package does, not on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DATA = dict(num_objects=400, num_views=16, seed=0)
# bench.py's config 3b (bench.py:237-242), less its epochs and epochs_per_dispatch
HEADLINE = dict(mode="joint", zdim=16, batch_size=128, obj_feature_dim=8, view_num_freqs=3,
                compute_dtype="bfloat16", dec_upsample="subpixel", polish_epochs=0)
KEYS = ("loss", "oos_mse")
# run in the tree's own directory: that tree's package
PORT = """
import json, sys, torch
from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.train.train_gppvae import GPPVAETrainConfig, train_gppvae
from gppvae_tpu_torch.utils import NullLogger
ds = build_rotated_digits("synthetic", **{data!r})
res = train_gppvae(ds, GPPVAETrainConfig(**{config!r}), device="cpu", log=NullLogger())
print("RESULT " + json.dumps([{{k: h[k] for k in ("epoch", "sec_epoch", *{keys!r})}}
                              for h in res.history]), flush=True)
"""


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def jax_history(config: dict) -> list[dict]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train.train_gppvae import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu.utils.metrics import NullLogger

    ds = build_rotated_digits("synthetic", **DATA)
    res = train_gppvae(ds, GPPVAETrainConfig(**config), log=NullLogger())
    return [{k: float(h[k]) for k in ("epoch", "sec_epoch", *KEYS)} for h in res.history]


def port_history(tree: str, config: dict) -> list[dict]:
    code = PORT.format(data=DATA, config=config, keys=KEYS)
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env, capture_output=True,
                         text=True, check=False)
    if out.returncode != 0:
        raise RuntimeError(f"the port's run in {tree} failed:\n{out.stderr[-3000:]}")
    line = next(s for s in out.stdout.splitlines() if s.startswith("RESULT "))
    return json.loads(line.removeprefix("RESULT "))


def gap(ours: list[dict], ref: list[dict]) -> dict:
    out = {}
    for k in KEYS:
        rel = [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(ours, ref, strict=True)]
        out[k] = {"final": rel[-1], "max": max(rel)}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--parent", default=None, help="another checkout of the port")
    args = p.parse_args()
    config = dict(HEADLINE, epochs=args.epochs, seed=args.seed)
    trees = {"port": ROOT, **({"parent": os.path.abspath(args.parent)} if args.parent else {})}
    runs, secs = {}, {}
    for name, fn in (("jax", lambda: jax_history(config)),
                     *((n, lambda t=t: port_history(t, config)) for n, t in trees.items())):
        t0 = time.perf_counter()
        runs[name] = fn()
        secs[name] = time.perf_counter() - t0
    for e, rows in enumerate(zip(*runs.values(), strict=True)):
        emit({"seed": args.seed, "epoch": e,
              **{f"{k}_{name}": row[k] for k in (*KEYS, "sec_epoch")
                 for name, row in zip(runs, rows)}})
    emit({"seed": args.seed, "epochs": args.epochs, "config": config,
          "wall_s": secs, "final": {n: {k: runs[n][-1][k] for k in KEYS} for n in runs},
          "gap_to_jax": {n: gap(runs[n], runs["jax"]) for n in trees}})


if __name__ == "__main__":
    main()
