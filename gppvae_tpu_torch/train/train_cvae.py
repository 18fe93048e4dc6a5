"""CVAE baseline driver (the paper's comparison model; no GP, no kernel).

Counterpart of gppvae_tpu/train/train_cvae.py: train_vae's loop on the
view-conditioned model, plain Adam, plus a per-epoch out-of-sample score:
for a held-out (object, view*) cell, the mean of the object's encoded latent
means over its training views, decoded at the target view.
validate_torch.py runs it for the paper's GPPVAE-vs-CVAE comparison.

    python -m gppvae_tpu_torch.train.train_cvae --data synthetic \
        --outdir out/cvae --device cuda

`outdir` receives metrics.jsonl, cvae_weights.pt (the state_dict),
final_state (weights, Adam state and epoch, the checkpoint format) and
oos_panel.png (held-out images over their predictions). Its draws are the
JAX trainer's at the same --seed: split(PRNGKey(seed), 3) for the run key
and flax's init key, then the epochs' plans and ε (train/batching.py).
`train_cvae` also takes an injected initial state_dict and a
`draws(epoch)` callable, so that a test can feed it draws of its own.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import torch

from gppvae_tpu_torch.checkpoint import save_tree
from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.eval.oos import pixel_mse
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.models import CVAE, UPSAMPLES
from gppvae_tpu_torch.train.batching import make_draws, masked_means
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
from gppvae_tpu_torch.train.train_gppvae import _data_tensors
from gppvae_tpu_torch.utils import MetricsLogger, prng

WEIGHTS_FILE = "cvae_weights.pt"


@dataclasses.dataclass(frozen=True)
class CVAETrainConfig:
    zdim: int = 16
    epochs: int = 50
    batch_size: int = 128
    lr: float = 2e-4
    seed: int = 0
    sigma_y: float = 0.1
    beta_kl: float = 1.0
    enc_features: Sequence[int] = (32, 64, 128)
    dec_features: Sequence[int] = (128, 64, 32)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' (compute; params f32)
    sat_penalty: float = 1.0  # saturation-death barrier weight (<=0 off)
    dec_upsample: str = "resize"  # 'resize' | 'subpixel' (same params: models/vae.py)
    outdir: str | None = None


@dataclasses.dataclass
class CVAETrainResult:
    model: CVAE
    config: CVAETrainConfig
    history: list[dict]


def cvae_loss(model: CVAE, y, q, eps, w, config: CVAETrainConfig):
    """(loss, (recon, kl, mse) masked means): Σ over valid rows / bs."""
    mu, logvar = model.encode(y, q)
    z = mu + torch.exp(0.5 * logvar) * eps
    logits = model.decode(z, q)
    recon, mse = gaussian_recon_nll(y, torch.sigmoid(logits), config.sigma_y)
    if config.sat_penalty > 0:
        recon = recon + config.sat_penalty * logit_saturation_penalty(logits)
    kl = kl_standard_normal(mu, logvar)
    loss = torch.sum(w * (recon + config.beta_kl * kl)) / y.shape[0]
    return loss, masked_means(w, recon, kl, mse)


@torch.no_grad()
def oos_eval(model: CVAE, data: dict, num_objects: int, chunk: int = 1024):
    """(ŷ, pixel MSE) for the held-out cells: each object's training latent
    means averaged (a segment mean over d_tr), decoded at the target view."""
    images, d_tr, q_tr = data["images_tr"], data["d_tr"], data["q_tr"]
    mu = torch.cat([model.encode(images[s:s + chunk], q_tr[s:s + chunk])[0]
                    for s in range(0, images.shape[0], chunk)])
    zsum = torch.zeros((num_objects, mu.shape[1]), device=mu.device).index_add_(0, d_tr, mu)
    counts = torch.bincount(d_tr, minlength=num_objects).clamp(min=1)
    zbar = zsum / counts[:, None]
    y_pred = torch.sigmoid(model.decode(zbar[data["d_ho"]], data["q_ho"]))
    return y_pred, pixel_mse(data["y_ho"], y_pred)


def train_cvae(
    dataset: GridDataset,
    config: CVAETrainConfig,
    *,
    device: torch.device | str,
    init_params: dict | None = None,
    draws: Callable | None = None,
    log: MetricsLogger | None = None,
) -> CVAETrainResult:
    """Train; init_params is a CVAE state_dict in place of the fresh init,
    draws(epoch) → (batches, weights, eps) in place of the seeded ones."""
    device = resolve_device(str(device))
    set_float32_precision(config.compute_dtype)
    own_log = log is None
    log = log or MetricsLogger(config.outdir)
    run_key, init_key, _ = prng.split(prng.PRNGKey(config.seed), 3)
    model = CVAE(config.zdim, dataset.image_shape, dataset.num_views, config.enc_features,
                 config.dec_features, config.dec_upsample, key=init_key,
                 dtype=compute_dtype(config.compute_dtype))
    if init_params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)

    data = _data_tensors(dataset, device)
    num_train, bs = len(dataset.train_idx), config.batch_size
    if bs > num_train:
        raise ValueError(f"batch_size {bs} exceeds train set {num_train}")
    draws = draws or make_draws(run_key, num_train, bs, config.zdim)

    history: list[dict] = []
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        batches, weights, eps = (t.to(device) for t in draws(epoch))
        rows = []
        for b in range(batches.shape[0]):
            pos = batches[b]
            loss, aux = cvae_loss(model, data["images_tr"][pos], data["q_tr"][pos],
                                  eps[b], weights[b], config)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            rows.append(torch.stack([loss.detach(), *aux]))
        _, oos = oos_eval(model, data, dataset.num_objects)
        row = [*torch.stack(rows).mean(dim=0).tolist(), float(oos)]
        rec = {"driver": "train_cvae", "epoch": epoch,
               **dict(zip(("loss", "recon_term", "kl_term", "mse", "oos_mse"), row)),
               "sec_epoch": time.perf_counter() - t0}
        log.log(rec)
        history.append(rec)

    if config.outdir:
        os.makedirs(config.outdir, exist_ok=True)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   os.path.join(config.outdir, WEIGHTS_FILE))
        save_tree(os.path.join(config.outdir, "final_state"),
                  {"cvae": model.state_dict(), "opt": opt.state_dict(), "epoch": config.epochs})
        y_pred, _ = oos_eval(model, data, dataset.num_objects)
        save_panel(os.path.join(config.outdir, "oos_panel.png"),
                   [data["y_ho"][:8].cpu().numpy(), y_pred[:8].cpu().numpy()])
    if own_log:
        log.close()
    return CVAETrainResult(model=model, config=config, history=history)


def main(argv=None) -> CVAETrainResult:
    import argparse

    p = argparse.ArgumentParser(
        description="CVAE comparison baseline (view-conditioned VAE, no GP)")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | sklearn | mnist:<dir> | faces[:h5:<path>] | npz:<path>")
    p.add_argument("--outdir", default="./out/cvae")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--zdim", type=int, default=16)
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_y", type=float, default=0.1)
    p.add_argument("--beta_kl", type=float, default=1.0)
    p.add_argument("--sat_penalty", type=float, default=1.0,
                   help="logit saturation barrier weight (<=0 off)")
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    p.add_argument("--dtype", default="float32", choices=list(COMPUTE_DTYPES),
                   help="compute dtype (params stay float32)")
    p.add_argument("--dec_upsample", default="resize", choices=list(UPSAMPLES))
    p.add_argument("--enc_features", default="32,64,128")
    p.add_argument("--dec_features", default="128,64,32")
    p.add_argument("--image_size", type=int, default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ds = build_dataset_from_flag(args.data, args.num_objects, args.num_views,
                                 args.seed, image_size=args.image_size)
    config = CVAETrainConfig(
        zdim=args.zdim, epochs=args.epochs, batch_size=args.bs, lr=args.lr,
        seed=args.seed, sigma_y=args.sigma_y, beta_kl=args.beta_kl,
        sat_penalty=args.sat_penalty, compute_dtype=args.dtype,
        dec_upsample=args.dec_upsample,
        enc_features=tuple(int(f) for f in args.enc_features.split(",")),
        dec_features=tuple(int(f) for f in args.dec_features.split(",")),
        outdir=args.outdir,
    )
    return train_cvae(ds, config, device=device)


if __name__ == "__main__":
    main()
