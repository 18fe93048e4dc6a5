"""Accuracy validation of the PyTorch port: the paper's ordering on real digits.

The twin of validate.py for `gppvae_tpu_torch`, with the same protocol, the
same JSON lines and the same verdict rule, on one GPU (or the CPU with
`--device cpu`). Casale et al. 2018 report that GPPVAE out-of-sample
conditional generation beats the non-GP baselines, with GPPVAE-joint ≤
GPPVAE-dis on pixel MSE. On the 1,797 handwritten 8×8 digits that
scikit-learn bundles (the port's own copy), rotated through 16 views:

    python validate_torch.py [--epochs 150] [--pretrain 60] [--fast] [--device cuda]

prints one JSON line per model (two trivial baselines, the VAE pretrain,
LIVAE, CVAE, GPPVAE-dis, GPPVAE-joint) and a summary line, and exits
non-zero unless gppvae_joint beats both trivial baselines and each GPPVAE
variant improves on its own first epoch.

`run_validation` is the library entry. Its seed 0 is the JAX package's seed
0: the port draws that package's random stream (gppvae_tpu_torch/utils/
prng.py), so in float32 this runs validate.py's protocol as the JAX
package would.
"""

import argparse
import json

import numpy as np


def trivial_baselines(ds) -> tuple[float, float]:
    """Out-of-sample pixel MSE of (the mean training image, the mean
    training image of the held-out cell's view)."""
    tr, ho = ds.train_idx, ds.heldout_idx
    y_ho = ds.images[ho]
    base_mean = float(np.mean((y_ho - ds.images[tr].mean(axis=0)) ** 2))
    view_means = np.stack([ds.images[tr][ds.view_ids[tr] == q].mean(axis=0)
                           for q in range(ds.num_views)])
    base_view = float(np.mean((y_ho - view_means[ds.view_ids[ho]]) ** 2))
    return base_mean, base_view


def livae_neighbours(ds) -> tuple[np.ndarray, np.ndarray]:
    """For each held-out cell, the grid rows (n = d·Q + q) of the same
    object's nearest TRAINING view on either side, walking outward mod Q:
    no validation or held-out row is interpolated from."""
    Q = ds.num_views
    train_mask = np.zeros(len(ds.images), dtype=bool)
    train_mask[ds.train_idx] = True

    def nearest_train(d, q, step):
        qq = (q + step) % Q
        for _ in range(Q):  # bounded: an object could lose every train view
            if train_mask[d * Q + qq]:
                return d * Q + qq
            qq = (qq + step) % Q
        raise ValueError(
            f"object {d} has no training views (all {Q} drawn into "
            "val/heldout); lower val_fraction or heldout_per_object")

    cells = list(zip(ds.object_ids[ds.heldout_idx], ds.view_ids[ds.heldout_idx]))
    return (np.array([nearest_train(d, q, -1) for d, q in cells]),
            np.array([nearest_train(d, q, +1) for d, q in cells]))


def run_validation(
    epochs: int = 150,
    pretrain: int = 60,
    num_objects: int = 180,
    fast: bool = False,
    outdir: str | None = None,
    emit=print,
    device: str = "cuda",
) -> dict:
    """Run the full accuracy protocol on `device`; returns the summary.

    fast=True: bfloat16 compute + the subpixel decoder on every model.
    emit: the sink of the per-model JSON lines.
    """
    import torch

    from gppvae_tpu_torch.data import build_rotated_digits
    from gppvae_tpu_torch.models import encode_all
    from gppvae_tpu_torch.train.train_cvae import CVAETrainConfig, train_cvae
    from gppvae_tpu_torch.train.train_gppvae import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu_torch.train.train_vae import VAETrainConfig, train_vae
    from gppvae_tpu_torch.utils import NullLogger

    fast_kw = dict(compute_dtype="bfloat16", dec_upsample="subpixel") if fast else {}
    ds = build_rotated_digits("sklearn", num_objects=num_objects, num_views=16, seed=0)
    y_ho = ds.images[ds.heldout_idx]

    base_mean, base_view = trivial_baselines(ds)
    emit(json.dumps({"model": "baseline_train_mean", "oos_mse": base_mean}), flush=True)
    emit(json.dumps({"model": "baseline_per_view_mean", "oos_mse": base_view}), flush=True)

    vae = train_vae(ds, VAETrainConfig(
        zdim=16, epochs=pretrain, batch_size=128, lr=1e-3, seed=0, **fast_kw,
    ), device=device, log=NullLogger())
    emit(json.dumps({"model": "vae_pretrain", "recon_mse": vae.history[-1]["mse"]}), flush=True)

    # LIVAE baseline (paper comparison): decode the mean of the same
    # object's encoded latents at the two training views nearest the
    # held-out angle; a VAE with hand-made latent geometry, no GP
    model = vae.model
    images = torch.from_numpy(ds.images).to(next(model.parameters()).device)
    mu_all = encode_all(model, images, 1024)
    lo, hi = livae_neighbours(ds)
    with torch.no_grad():
        y_livae = torch.sigmoid(model.decode(0.5 * (mu_all[lo] + mu_all[hi]))).cpu().numpy()
    livae_mse = float(np.mean((y_ho - y_livae) ** 2))
    emit(json.dumps({"model": "livae", "oos_mse": livae_mse}), flush=True)

    # CVAE baseline (the paper's non-GP comparison model)
    cvae = train_cvae(ds, CVAETrainConfig(
        zdim=16, epochs=pretrain + epochs, batch_size=128, lr=1e-3, seed=0, **fast_kw,
    ), device=device, log=NullLogger())
    emit(json.dumps({
        "model": "cvae",
        "oos_mse": cvae.history[-1]["oos_mse"],
        "recon_mse": cvae.history[-1]["mse"],
    }), flush=True)

    vae_weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    results = {}
    per_mode = []
    for mode in ("dis", "joint"):
        cfg = GPPVAETrainConfig(
            mode=mode, zdim=16, epochs=epochs, batch_size=128,
            lr_vae=5e-4, lr_gp=3e-3, seed=0,
            obj_feature_dim=8, view_num_freqs=3, **fast_kw,
            outdir=outdir and f"{outdir}/{mode}",
            panel_every=epochs - 1 if outdir else 0,
        )
        r = train_gppvae(ds, cfg, device=device, init_params={"vae": vae_weights},
                         log=NullLogger())
        first, last = r.history[0], r.history[-1]
        results[mode] = last["oos_mse"]
        per_mode.append({"oos_mse": last["oos_mse"], "oos_mse_epoch0": first["oos_mse"]})
        emit(json.dumps({
            "model": f"gppvae_{mode}",
            "oos_mse": last["oos_mse"],
            "oos_mse_epoch0": first["oos_mse"],
            "recon_mse": last["mse"],
            "gp_nll_full": last["gp_nll_full"],
            "sec_epoch": last["sec_epoch"],
        }), flush=True)

    ok = results["joint"] < base_mean and results["joint"] < base_view
    # and each GPPVAE variant must have improved on its own epoch-0 state
    ok = ok and all(r["oos_mse"] < r["oos_mse_epoch0"] for r in per_mode)
    summary = {
        "verdict": "PASS" if ok else "FAIL",
        "gppvae_joint_oos_mse": results["joint"],
        "gppvae_dis_oos_mse": results["dis"],
        "baseline_train_mean": base_mean,
        "baseline_per_view_mean": base_view,
        "livae_oos_mse": livae_mse,
        "cvae_oos_mse": cvae.history[-1]["oos_mse"],
        "joint_vs_best_baseline": results["joint"] / min(base_mean, base_view),
        "joint_vs_dis": results["joint"] / results["dis"],
        "joint_vs_cvae": results["joint"] / cvae.history[-1]["oos_mse"],
        "protocol": {
            "data": "sklearn digits (real)", "num_objects": num_objects,
            "num_views": 16, "pretrain_epochs": pretrain, "epochs": epochs,
            "fast": fast,
        },
    }
    emit(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--pretrain", type=int, default=60)
    p.add_argument("--num_objects", type=int, default=180)
    p.add_argument("--outdir", default=None)
    p.add_argument("--fast", action="store_true",
                   help="bfloat16 compute + subpixel decoder on every model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    summary = run_validation(
        epochs=args.epochs, pretrain=args.pretrain,
        num_objects=args.num_objects, fast=args.fast, outdir=args.outdir,
        device=args.device,
    )
    if summary["verdict"] != "PASS":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
