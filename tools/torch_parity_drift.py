"""Does the port drift from the JAX trainer over a protocol-length run? On the CPU.

    JAX_PLATFORMS=cpu python tools/torch_parity_drift.py [--epochs 60] \\
        [--seeds 0,1,2,3] [--out drift.jsonl] \\
        [--enc_features 32,64,128 --dec_features 128,64,32]

The parity trajectories of tests/test_torch_train.py are 2 and 12 epochs long
at a narrow width. This runs both trainers at the accuracy protocol's own
configuration (validate.py / validate_torch.py: the bundled 8×8 digits × 16
rotations at 32², zdim 16, the published encoder and decoder, bs 128, lr_vae
5e-4, lr_gp 3e-3, xdim 8, 3 view frequencies, the JAX trainer at
epochs_per_dispatch=10) on 40 objects after a 20-epoch VAE pretrain, so that
a CPU can do it. XLA's CPU
convolutions make one 60-epoch stage of the JAX trainer take over half an
hour at the published widths on 8 cores; --enc_features / --dec_features
narrow the VAE (the first printed line records them).

Part 1, injected draws: one VAE pretrain (the JAX trainer's), then GPPVAE-dis
and GPPVAE-joint for --epochs in both packages from the same initial
parameters, the port fed the JAX trainer's minibatch plans and ε. One JSON
line per (mode, epoch) with `oos_mse`, `v_sig`, `v_noise` and `gp_nll_full` of
both and their relative difference, then per mode the largest relative
difference in the first and in the last third of the run. Two float32
programs that round differently drift apart slowly under Adam; a fault in the
optimizer, the accumulation or the surrogate's refresh shows as a difference
that grows by orders of magnitude with the epoch.

Part 2, own draws: both packages' GPPVAE stages at training seeds --seeds from
that same pretrained VAE, each drawing for itself from the seed: the final
`oos_mse` of dis and joint per seed, and each package's mean and spread,
side by side. The port draws the JAX package's threefry stream
(gppvae_tpu_torch/utils/prng.py), so part 2 is part 1 without injection.

A tool, not part of the port's package: it imports both packages. Every number
it prints is a CPU number at a reduced size; none is a device time.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches  # noqa: E402
from gppvae_tpu.train.batching import epoch_keys  # noqa: E402
from gppvae_tpu.train import VAETrainConfig as JVAETrainConfig  # noqa: E402
from gppvae_tpu.train import train_vae as jax_train_vae  # noqa: E402
from gppvae_tpu.utils.metrics import NullLogger as JNullLogger  # noqa: E402
from gppvae_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from gppvae_tpu_torch.data import build_rotated_digits  # noqa: E402
from gppvae_tpu_torch.train import train_gppvae as tg  # noqa: E402
from gppvae_tpu_torch.utils import NullLogger  # noqa: E402

jtrain = importlib.import_module("gppvae_tpu.train.train_gppvae")
NUM_OBJECTS, PRETRAIN = 40, 20
KEYS = ("oos_mse", "v_sig", "v_noise", "gp_nll_full")
PROTOCOL = dict(zdim=16, batch_size=128, lr_vae=5e-4, lr_gp=3e-3, obj_feature_dim=8,
                view_num_freqs=3)


def jax_draws(rng, num_train: int, bs: int, zdim: int):
    """The JAX trainer's minibatch plan and ε of one epoch, as the port's
    `draws` callback (train_gppvae.py: epoch_keys → epoch_batches, ε from
    split(fold_in(epoch_key, 1), nb))."""
    def draws(epoch: int):
        key = epoch_keys(rng, epoch, 1)[0]
        batches, weights = jax_epoch_batches(key, num_train, bs)
        step_keys = jax.random.split(jax.random.fold_in(key, 1), batches.shape[0])
        eps = jnp.stack([jax.random.normal(k, (bs, zdim), jnp.float32) for k in step_keys])
        b, w, e = (torch.from_numpy(np.array(a)) for a in (batches, weights, eps))
        return b.long(), w, e
    return draws


def both_trainers(ds, mode: str, seed: int, epochs: int, vae_params, widths: dict, *,
                  inject: bool):
    """(JAX history, port history) of one GPPVAE stage from the pretrained
    VAE. inject=True: the port starts from the JAX trainer's GP init and is
    fed its draws; False: each package draws for itself from `seed`."""
    jcfg = jtrain.GPPVAETrainConfig(mode=mode, epochs=epochs, seed=seed,
                                    epochs_per_dispatch=10, **PROTOCOL, **widths)
    jhist = jtrain.train_gppvae(ds, jcfg, vae_params=vae_params, log=JNullLogger()).history
    cfg = tg.GPPVAETrainConfig(mode=mode, epochs=epochs, seed=seed, **PROTOCOL, **widths)
    init = {"vae": flax_to_state_dict(jax.tree.map(np.asarray, vae_params))}
    draws = None
    if inject:
        _, params, _, _, rng, num_train = jtrain._setup(ds, jcfg, vae_params, None)
        init["gp"] = {k: np.asarray(v) for k, v in params["gp"].items()}
        draws = jax_draws(rng, num_train, PROTOCOL["batch_size"], PROTOCOL["zdim"])
    thist = tg.train_gppvae(ds, cfg, device="cpu", init_params=init, draws=draws,
                            log=NullLogger()).history
    return jhist, thist


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--seeds", default="0,1,2,3", help="part 2's training seeds; '' skips it")
    p.add_argument("--enc_features", default="32,64,128")
    p.add_argument("--dec_features", default="128,64,32")
    p.add_argument("--out", default=None, help="also append every JSON line to this file")
    args = p.parse_args()
    torch.set_num_threads(4)
    widths = {k: tuple(int(f) for f in getattr(args, k).split(","))
              for k in ("enc_features", "dec_features")}

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    ds = build_rotated_digits("sklearn", num_objects=NUM_OBJECTS, num_views=16, seed=0)
    emit({"device": "cpu", "note": "CPU run at reduced size; no number here is a device time",
          "num_objects": NUM_OBJECTS, "num_views": 16, "train_rows": len(ds.train_idx),
          "heldout_rows": len(ds.heldout_idx), "pretrain": PRETRAIN, "epochs": args.epochs,
          "torch": torch.__version__, "jax": jax.__version__, **PROTOCOL, **widths})
    vae = jax_train_vae(ds, JVAETrainConfig(zdim=16, epochs=PRETRAIN, batch_size=128,
                                            lr=1e-3, seed=0, **widths), log=JNullLogger())
    emit({"stage": "vae_pretrain (JAX trainer)", "recon_mse": float(vae.history[-1]["mse"])})

    for mode in ("dis", "joint"):
        jhist, thist = both_trainers(ds, mode, 0, args.epochs, vae.vae_params, widths,
                                     inject=True)
        rel = {k: [] for k in KEYS}
        for j, t in zip(jhist, thist):
            r = {k: abs(t[k] - j[k]) / max(abs(j[k]), 1e-30) for k in KEYS}
            for k in KEYS:
                rel[k].append(r[k])
            emit({"part": "injected", "mode": mode, "epoch": j["epoch"],
                  "jax": {k: j[k] for k in KEYS}, "torch": {k: t[k] for k in KEYS}, "rel": r})
        third = max(1, args.epochs // 3)
        emit({"part": "injected", "mode": mode, "summary": {
            k: {"max_rel_first_third": max(rel[k][:third]),
                "max_rel_last_third": max(rel[k][-third:]), "rel_final": rel[k][-1]}
            for k in KEYS}})

    seeds = [int(s) for s in args.seeds.split(",") if s]
    finals = {(pkg, mode): [] for pkg in ("jax", "torch") for mode in ("dis", "joint")}
    for seed in seeds:
        rec = {"part": "own_draws", "seed": seed}
        for mode in ("dis", "joint"):
            jhist, thist = both_trainers(ds, mode, seed, args.epochs, vae.vae_params, widths,
                                         inject=False)
            rec[f"jax_{mode}"], rec[f"torch_{mode}"] = jhist[-1]["oos_mse"], thist[-1]["oos_mse"]
            finals["jax", mode].append(jhist[-1]["oos_mse"])
            finals["torch", mode].append(thist[-1]["oos_mse"])
        rec["jax_joint_over_dis"] = rec["jax_joint"] / rec["jax_dis"]
        rec["torch_joint_over_dis"] = rec["torch_joint"] / rec["torch_dis"]
        emit(rec)
    if seeds:
        emit({"part": "own_draws", "seeds": seeds, "summary": {
            f"{pkg}_{mode}": {"mean": float(np.mean(v)), "min": min(v), "max": max(v)}
            for (pkg, mode), v in finals.items()}})


if __name__ == "__main__":
    main()
