"""Vanilla conv-VAE pretrain driver: GPPVAE stage 1.

Counterpart of gppvae_tpu/train/train_vae.py. Writes `vae_weights.pt` (the
VAE state_dict, via torch.save) into --outdir: the handoff that
train_gppvae's --vae_weights reads.

    python -m gppvae_tpu_torch.train.train_vae --data synthetic \
        --outdir out/vae --device cuda
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import torch

from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.models import UPSAMPLES, VAE
from gppvae_tpu_torch.train.batching import epoch_batches, masked_means, num_batches
from gppvae_tpu_torch.train.device import (
    COMPUTE_DTYPES,
    compute_dtype,
    resolve_device,
    set_float32_precision,
)
from gppvae_tpu_torch.train.losses import (
    gaussian_recon_nll,
    kl_standard_normal,
    logit_saturation_penalty,
)
from gppvae_tpu_torch.utils import MetricsLogger

WEIGHTS_FILE = "vae_weights.pt"


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    zdim: int = 16
    epochs: int = 50
    batch_size: int = 128
    lr: float = 2e-4
    seed: int = 0
    sigma_y: float = 0.1  # decoder Gaussian likelihood std
    beta_kl: float = 1.0
    enc_features: Sequence[int] = (32, 64, 128)
    dec_features: Sequence[int] = (128, 64, 32)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' (VAE compute; params f32)
    sat_penalty: float = 1.0  # saturation-death barrier weight (<=0 off)
    dec_upsample: str = "resize"  # 'resize' | 'subpixel' (same forward and params)
    outdir: str | None = None


@dataclasses.dataclass
class VAETrainResult:
    model: VAE
    config: VAETrainConfig
    history: list[dict]


def vae_loss(model: VAE, y, eps, w, config: VAETrainConfig):
    """(loss, (recon, kl, mse) masked means): Σ over valid rows / bs."""
    mu, logvar = model.encode(y)
    z = mu + torch.exp(0.5 * logvar) * eps
    logits = model.decode(z)
    recon, mse = gaussian_recon_nll(y, torch.sigmoid(logits), config.sigma_y)
    if config.sat_penalty > 0:
        recon = recon + config.sat_penalty * logit_saturation_penalty(logits)
    kl = kl_standard_normal(mu, logvar)
    loss = torch.sum(w * (recon + config.beta_kl * kl)) / y.shape[0]
    return loss, masked_means(w, recon, kl, mse)


def train_vae(
    dataset: GridDataset,
    config: VAETrainConfig,
    *,
    device: torch.device | str,
    log: MetricsLogger | None = None,
) -> VAETrainResult:
    device = resolve_device(str(device))
    set_float32_precision(config.compute_dtype)
    own_log = log is None
    log = log or MetricsLogger(config.outdir)
    gen = torch.Generator().manual_seed(config.seed)
    model = VAE(config.zdim, dataset.image_shape, config.enc_features,
                config.dec_features, config.dec_upsample, generator=gen,
                dtype=compute_dtype(config.compute_dtype)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)

    images = torch.from_numpy(dataset.images).to(device)
    train_idx = torch.from_numpy(dataset.train_idx.astype("int64")).to(device)
    val_idx = torch.from_numpy(dataset.val_idx.astype("int64")).to(device)
    n, bs = len(train_idx), config.batch_size
    nb = num_batches(n, bs)

    history: list[dict] = []
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        batches, weights = epoch_batches(gen, n, bs)
        eps = torch.randn((nb, bs, config.zdim), generator=gen)
        batches, weights, eps = batches.to(device), weights.to(device), eps.to(device)
        rows = []
        for b in range(nb):
            y = images[train_idx[batches[b]]]
            loss, aux = vae_loss(model, y, eps[b], weights[b], config)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            rows.append(torch.stack([loss.detach(), *aux]))
        row = torch.stack(rows).mean(dim=0).tolist()
        rec = {"driver": "train_vae", "epoch": epoch,
               **dict(zip(("loss", "recon_term", "kl_term", "mse"), row))}
        if len(val_idx):
            eps_v = torch.randn((len(val_idx), config.zdim), generator=gen).to(device)
            with torch.no_grad():
                yv = images[val_idx]
                # the val mean of recon + β·KL, without the saturation barrier
                # (as the JAX driver reports it)
                loss_v, (_, _, mse_v) = vae_loss(
                    model, yv, eps_v, torch.ones(len(val_idx), device=device),
                    dataclasses.replace(config, sat_penalty=0.0))
            rec["val_loss"], rec["val_mse"] = float(loss_v), float(mse_v)
        rec["sec_epoch"] = time.perf_counter() - t0
        log.log(rec)
        history.append(rec)

    if config.outdir:
        os.makedirs(config.outdir, exist_ok=True)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   os.path.join(config.outdir, WEIGHTS_FILE))
    if own_log:
        log.close()
    return VAETrainResult(model=model, config=config, history=history)


def main(argv=None) -> VAETrainResult:
    import argparse

    p = argparse.ArgumentParser(description="Vanilla conv-VAE pretrain (GPPVAE stage 1)")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | sklearn | mnist:<dir> | faces[:h5:<path>] | npz:<path>")
    p.add_argument("--outdir", default="./out/vae")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--zdim", type=int, default=16)
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_y", type=float, default=0.1)
    p.add_argument("--beta_kl", type=float, default=1.0)
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    p.add_argument("--dtype", default="float32", choices=list(COMPUTE_DTYPES),
                   help="VAE compute dtype (params stay float32)")
    p.add_argument("--dec_upsample", default="resize", choices=list(UPSAMPLES))
    p.add_argument("--enc_features", default="32,64,128")
    p.add_argument("--dec_features", default="128,64,32")
    p.add_argument("--image_size", type=int, default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ds = build_dataset_from_flag(args.data, args.num_objects, args.num_views,
                                 args.seed, image_size=args.image_size)
    config = VAETrainConfig(
        zdim=args.zdim, epochs=args.epochs, batch_size=args.bs, lr=args.lr,
        seed=args.seed, sigma_y=args.sigma_y, beta_kl=args.beta_kl,
        compute_dtype=args.dtype, dec_upsample=args.dec_upsample,
        enc_features=tuple(int(f) for f in args.enc_features.split(",")),
        dec_features=tuple(int(f) for f in args.dec_features.split(",")),
        outdir=args.outdir,
    )
    return train_vae(ds, config, device=device)


if __name__ == "__main__":
    main()
