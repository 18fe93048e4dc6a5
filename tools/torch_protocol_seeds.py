"""The accuracy protocol's GPPVAE stages at other training seeds, on the GPU.

    python tools/torch_protocol_seeds.py [--seeds 1,2,3] [--epochs 150] [--pretrain 60]

validate_torch.py fixes every seed at 0. This runs its VAE pretrain and its
GPPVAE-dis and GPPVAE-joint stages (the same dataset, split, widths and
learning rates) with the training seed varied, which moves the initial
weights, the object features' init, the minibatch plans and ε (each the
JAX package's draw at that seed: the port draws its stream), and prints
one JSON line per (seed, mode): the final out-of-sample MSE, the MSE at
epoch 100 and the lowest over the run. It says how far the protocol's
numbers move with the seed alone. Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gppvae_tpu_torch.data import build_rotated_digits  # noqa: E402
from gppvae_tpu_torch.train.train_gppvae import GPPVAETrainConfig, train_gppvae  # noqa: E402
from gppvae_tpu_torch.train.train_vae import VAETrainConfig, train_vae  # noqa: E402
from gppvae_tpu_torch.utils import NullLogger  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--pretrain", type=int, default=60)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_protocol_seeds.py runs on the GPU; CUDA is not available")
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    ds = build_rotated_digits("sklearn", num_objects=180, num_views=16, seed=0)
    for seed in (int(s) for s in args.seeds.split(",")):
        vae = train_vae(ds, VAETrainConfig(zdim=16, epochs=args.pretrain, batch_size=128,
                                           lr=1e-3, seed=seed),
                        device="cuda", log=NullLogger())
        weights = {k: v.detach().cpu().clone() for k, v in vae.model.state_dict().items()}
        for mode in ("dis", "joint"):
            t0 = time.perf_counter()
            cfg = GPPVAETrainConfig(mode=mode, zdim=16, epochs=args.epochs, batch_size=128,
                                    lr_vae=5e-4, lr_gp=3e-3, seed=seed, obj_feature_dim=8,
                                    view_num_freqs=3)
            hist = train_gppvae(ds, cfg, device="cuda", init_params={"vae": weights},
                                log=NullLogger()).history
            print(json.dumps({
                "seed": seed, "mode": mode, "vae_recon_mse": vae.history[-1]["mse"],
                "oos_mse": hist[-1]["oos_mse"],
                "oos_mse_epoch100": hist[min(99, len(hist) - 1)]["oos_mse"],
                "oos_mse_min": min(h["oos_mse"] for h in hist),
                "recon_mse": hist[-1]["mse"], "v_sig": hist[-1]["v_sig"],
                "v_noise": hist[-1]["v_noise"], "wall_s": time.perf_counter() - t0,
            }), flush=True)


if __name__ == "__main__":
    main()
