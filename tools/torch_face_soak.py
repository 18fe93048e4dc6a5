"""Face-view soak: is the saturation barrier inert on real-valued data? On the GPU.

    python tools/torch_face_soak.py [--epochs 150] [--device cuda]

The twin of tools/face_soak.py. Two arms at one seed on synthetic faces
(50 people × 8 poses at 128², zdim 32, bs 64, xdim 8, 3 view frequencies,
bfloat16 with the subpixel decoder, GPPVAE-joint): `sat_penalty` 1 (the
default) against 0. The barrier's value and gradient are exactly zero while
every logit stays inside its bound, so an inert barrier leaves the two
trajectories equal: bit for bit on the CPU, and on the card up to cuDNN's
run-to-run summation order, which a third arm measures
(`sat_penalty` 1 once more). One JSON line per arm (out-of-sample MSE at a
few epochs, all losses finite), then the largest |logit| of the trained
default arm against the barrier's bound and the largest difference between
the arms beside the run-to-run one. `--device cpu` runs the same at whatever
depth a CPU allows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gppvae_tpu_torch.data import build_faceplace  # noqa: E402
from gppvae_tpu_torch.models import encode_all  # noqa: E402
from gppvae_tpu_torch.train.losses import SAT_LOGIT_BOUND  # noqa: E402
from gppvae_tpu_torch.train.train_gppvae import GPPVAETrainConfig, train_gppvae  # noqa: E402
from gppvae_tpu_torch.utils import NullLogger  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but CUDA is not available; pass --device cpu")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"device {smi.stdout.strip()}", flush=True)
    ds = build_faceplace("synthetic", num_people=50, num_poses=8, image_size=128, seed=0)
    arms = {}
    for arm, sat in (("sat1", 1.0), ("sat0", 0.0), ("sat1_again", 1.0)):
        cfg = GPPVAETrainConfig(mode="joint", zdim=32, epochs=args.epochs, batch_size=64,
                                obj_feature_dim=8, view_num_freqs=3, seed=0,
                                dec_upsample="subpixel", compute_dtype="bfloat16",
                                sat_penalty=sat)
        t0 = time.perf_counter()
        res = train_gppvae(ds, cfg, device=args.device, log=NullLogger())
        oos = np.array([h["oos_mse"] for h in res.history], np.float64)
        arms[arm] = (res, oos)
        at = sorted({0, args.epochs // 10, args.epochs // 2, args.epochs - 1})
        print(json.dumps({
            "arm": arm, "sat_penalty": sat, "epochs": args.epochs,
            "oos_mse_at": {str(e): float(oos[e]) for e in at}, "oos_mse_min": float(oos.min()),
            "all_finite": bool(np.isfinite([h["loss"] for h in res.history]).all()),
            "wall_s": round(time.perf_counter() - t0, 1),
        }), flush=True)

    # the largest |logit| of the trained default arm: float32 decode of the
    # encoder means of up to 256 training rows
    res, _ = arms["sat1"]
    res.model.dtype = torch.float32
    with torch.no_grad():
        mu = encode_all(res.model, res.data["images_tr"][:256], 64)
        max_logit = float(res.model.decode(mu).abs().max())
    a, b, again = arms["sat1"][1], arms["sat0"][1], arms["sat1_again"][1]
    print(json.dumps({
        "max_abs_logit": max_logit, "bound": SAT_LOGIT_BOUND,
        "traj_max_abs_oos_diff": float(np.max(np.abs(a - b))),
        "traj_max_rel_oos_diff": float(np.max(np.abs(a - b) / a)),
        "run_to_run_max_rel_oos_diff": float(np.max(np.abs(a - again) / a)),
        "trajectories_identical": bool(np.array_equal(a, b)),
    }), flush=True)


if __name__ == "__main__":
    main()
