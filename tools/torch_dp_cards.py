#!/usr/bin/env python3
"""GPPVAE-joint at the slice's width, one rank per card over NCCL, against one
process.

    python3 tools/torch_dp_cards.py [--worlds 2,4] [--epochs 2]
    python3 tools/torch_dp_cards.py --mesh 2x2   # the data × model mesh only

The multi-card counterpart of chip_smoke.py path 9 (a), whose 2 gloo ranks
share one card: here rank r runs on cuda:r over NCCL. The same grid and
widths (P = 400 × Q = 16, 5,700 training rows, zdim 16, R = 56, float32,
bs 128, from a VAE pretrained for 1 epoch); two single-process runs on cuda:0,
whose spread sets the bound (at least 1e-4, as in path 9); then one run per
world size, every history key held to the single process, each rank's kernel
launches checked (one of each per epoch), the collectives and sec/epoch of
each epoch printed beside one process's. `--mesh DxM` also runs (alone,
unless --worlds is given) D × M ranks as the 2-D data × model mesh, the
multi-card counterpart of chip_smoke.py path 10 (a): tensor parallelism at
the default threshold (seven weights split), the model axis's activations
gathered with NCCL's all-gather, the collectives per axis. Needs as many
cards as the largest world size; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402

KEYS = ("loss", "recon_term", "gp_term", "pen_term", "mse", "gp_nll_full", "v_sig",
        "v_noise", "oos_mse")


def main(argv=None) -> dict:
    import torch

    from gppvae_tpu_torch.parallel import RankPool, dryrun
    from gppvae_tpu_torch.train import train_vae

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worlds", default=None,
                   help="comma-separated world sizes (default 2,4; none with --mesh)")
    p.add_argument("--mesh", default=None, help="DxM: a data × model mesh of D·M ranks")
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args(argv)
    worlds_flag = args.worlds if args.worlds is not None else ("" if args.mesh else "2,4")
    runs = [(int(w), None) for w in worlds_flag.split(",") if w]
    if args.mesh:
        mesh = tuple(int(a) for a in args.mesh.lower().split("x"))
        runs.append((mesh[0] * mesh[1], mesh))
    worlds = [w for w, _ in runs]
    _, card = c.phase_environment()
    cards = torch.cuda.device_count()
    c.check(cards >= max(worlds), f"{max(worlds)} ranks need as many cards; {cards} found")
    c.phase_build()
    out: dict = {"card": card, "cards": cards}
    with tempfile.TemporaryDirectory(prefix="dp_cards_") as tmp:
        train_vae.main([*c.SLICE_ARGS, "--epochs", "1", "--outdir", f"{tmp}/vae",
                        "--panel_every", "0"])
        config = {**c.DP_GPPVAE, "epochs": args.epochs,
                  "vae_weights": f"{tmp}/vae/{train_vae.WEIGHTS_FILE}"}
        singles = [dryrun.train_gppvae(c.DP_DATA, config, "cuda:0") for _ in range(2)]
        out["single_sec_epoch"] = [h["sec_epoch"] for h in singles[0]["history"]]
        for world, mesh in runs:
            label = f"{world} NCCL ranks, one per card" + (
                f", a {mesh[0]} × {mesh[1]} data × model mesh" if mesh else "")
            t0 = time.perf_counter()
            with RankPool(world, backend="nccl", device="cuda", mesh=mesh) as pool:
                joined = time.perf_counter() - t0
                ranks = pool.run(dryrun.train_gppvae_rank, c.DP_DATA, config)
            worst = c.dp_against_one(label, ranks, singles, KEYS)
            for rank, r in enumerate(ranks):
                n = r["launches"]
                c.check(n["launch_factor_prep.launches"] == n["launch_nll_core.launches"]
                        == args.epochs and n["factor_prep_torch.cuda_calls"] == 0,
                        f"{label}: rank {rank} launched each kernel once per epoch")
            if mesh:
                split = dryrun.check_blocks(ranks, mesh[1])
                c.check(set(split) == c.TP_SPLIT, f"{label}: the seven weights split")
            for h, hs in zip(ranks[0]["history"], singles[0]["history"]):
                if mesh:
                    c.say(f"{label}, epoch {h['epoch']}: collectives per axis "
                          f"{json.dumps(c.per_axis(h['collectives']))}")
                c.say(f"{label}, epoch {h['epoch']}: collectives {json.dumps(h['collectives'])}; "
                      f"sec_epoch {h['sec_epoch']:.4f} (A {h['sec_A_encode']:.4f}, B "
                      f"{h['sec_B_solve']:.4f}, C {h['sec_C_minibatch']:.4f}, eval "
                      f"{h['sec_eval_oos']:.4f}), one process {hs['sec_epoch']:.4f} on {card}")
            out[f"mesh_{mesh[0]}x{mesh[1]}" if mesh else f"world_{world}"] = {
                "joined_s": joined, "worst_rel": worst,
                "sec_epoch": [h["sec_epoch"] for h in ranks[0]["history"]],
                "sec_C_minibatch": [h["sec_C_minibatch"] for h in ranks[0]["history"]],
                "collectives": ranks[0]["history"][-1]["collectives"]}
    c.say(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
