"""Vanilla conv-VAE pretrain driver: GPPVAE stage 1.

Counterpart of gppvae_tpu/train/train_vae.py. Writes `vae_weights.pt` (the
VAE state_dict, via torch.save) into --outdir: the handoff that
train_gppvae's --vae_weights reads. Beside it: `final_state` (weights, Adam
state and epoch, the checkpoint format), `panel_NNNN.png` every
--panel_every epochs (8 validation images over their reconstructions) and
`vae_weights_NNNN.pt` every --checkpoint_every epochs.

Every random draw is the JAX trainer's at the same --seed (utils/prng.py):
split(PRNGKey(seed), 3) gives the run key and the VAE's init key; epoch e
draws from fold_in(run key, e) its plan and ε (train/batching.py), the
validation rows' ε from fold_in(·, 2) and a panel's from fold_in(·, 3).

With `group` (a parallel.DataGroup per rank) the run is data-parallel, as
the JAX driver runs under a 1-D mesh (train_vae.py:183-222): the image array
is split into `world` contiguous blocks (parallel.row_block: the rows that
would pad it to a multiple of the world size are never indexed, so they are
not stored), the parameters and the random stream are the same on every
rank, each rank computes the rows of each batch whose image lies in its
block, and one all-reduce sums the gradients with the step's metric sums
before Adam; the validation rows are split and reduced the same way. Rank 0
alone writes outdir and logs.

With a parallel.MeshGroup (a rank of a data × model mesh) the driver does
what the JAX driver does under make_mesh_2d (train_vae.py:197-211): no
tensor parallelism, the parameters replicated on every rank, the rows split
over the data axis and the gradient all-reduce over the data axis only; the
ranks of a model row compute the same rows, and the reduced gradients are
made alike on the row by one broadcast (parallel.all_reduce_grads).

    python -m gppvae_tpu_torch.train.train_vae --data synthetic \
        --outdir out/vae --device cuda
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
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.models import (
    ARCH_DEFAULTS,
    VAE,
    add_arch_flags,
    arch_from_flags,
    sample_reconstruction,
    vae_from_record,
)
from gppvae_tpu_torch.parallel import all_reduce, all_reduce_grads, replicate, row_block
from gppvae_tpu_torch.train.batching import make_draws, masked_means, num_batches
from gppvae_tpu_torch.train.device import resolve_device, set_float32_precision
from gppvae_tpu_torch.train.losses import (
    gaussian_recon_nll,
    kl_standard_normal,
    logit_saturation_penalty,
)
from gppvae_tpu_torch.utils import MetricsLogger, NullLogger, prng

WEIGHTS_FILE = "vae_weights.pt"


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    zdim: int = ARCH_DEFAULTS["zdim"]
    epochs: int = 50
    batch_size: int = 128
    lr: float = 2e-4
    seed: int = 0
    sigma_y: float = 0.1  # decoder Gaussian likelihood std
    beta_kl: float = 1.0
    enc_features: Sequence[int] = ARCH_DEFAULTS["enc_features"]
    dec_features: Sequence[int] = ARCH_DEFAULTS["dec_features"]
    compute_dtype: str = ARCH_DEFAULTS["compute_dtype"]  # VAE compute; params f32
    sat_penalty: float = 1.0  # saturation-death barrier weight (<=0 off)
    dec_upsample: str = ARCH_DEFAULTS["dec_upsample"]  # same params either way: models/vae.py
    vae_layout: str = ARCH_DEFAULTS["vae_layout"]  # train_gppvae takes the same
    outdir: str | None = None
    panel_every: int = 0  # epochs between image panels (0 = off)
    checkpoint_every: int = 0  # epochs between vae_weights_NNNN.pt (0 = end only)


@dataclasses.dataclass
class VAETrainResult:
    model: VAE
    config: VAETrainConfig
    history: list[dict]


def vae_rows(model: VAE, y, eps, config: VAETrainConfig):
    """Per-row (recon, kl, mse) of the rows y with noise eps."""
    mu, logvar = model.encode(y)
    z = mu + torch.exp(0.5 * logvar) * eps
    logits = model.decode(z)
    recon, mse = gaussian_recon_nll(y, torch.sigmoid(logits), config.sigma_y)
    if config.sat_penalty > 0:
        recon = recon + config.sat_penalty * logit_saturation_penalty(logits)
    return recon, kl_standard_normal(mu, logvar), mse


def vae_loss(model: VAE, y, eps, w, config: VAETrainConfig):
    """(loss, (recon, kl, mse) masked means): Σ over valid rows / bs."""
    recon, kl, mse = vae_rows(model, y, eps, config)
    loss = torch.sum(w * (recon + config.beta_kl * kl)) / y.shape[0]
    return loss, masked_means(w, recon, kl, mse)


def _owned_rows(rows: torch.Tensor, block: slice) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, local index) of the image rows `rows` that lie in `block`."""
    own = (rows >= block.start) & (rows < block.stop)
    return own, rows[own] - block.start


def _reduced_sums(model: VAE, y, eps, w, config: VAETrainConfig, group, *,
                  backward: bool) -> torch.Tensor:
    """One rank's share of a batch (the rows it owns, maybe none): Σ w·(recon
    + β·KL) over bs, and Σ w·recon, Σ w·KL, Σ w·mse, Σ w, summed over the
    ranks; with backward, the share is differentiated first and the
    parameters' gradients are summed in the same all-reduce."""
    sums = torch.zeros(5, device=w.device)
    if w.numel():
        recon, kl, mse = vae_rows(model, y, eps, config)
        loss = torch.sum(w * (recon + config.beta_kl * kl)) / config.batch_size
        if backward:
            loss.backward()
        sums = torch.stack([loss, *(torch.sum(w * t) for t in (recon, kl, mse)),
                            torch.sum(w)]).detach()
    if backward:
        return all_reduce_grads(group, list(model.parameters()), sums)
    return all_reduce(group, sums)


def train_vae(
    dataset: GridDataset,
    config: VAETrainConfig,
    *,
    device: torch.device | str,
    log: MetricsLogger | None = None,
    init_params: dict | None = None,
    draws: Callable | None = None,
    group=None,
) -> VAETrainResult:
    """Train. init_params: a VAE state_dict in place of the fresh init.
    draws(epoch) → (batches (nb, bs) positions into the training rows,
    weights (nb, bs), ε (nb, bs, zdim), the validation rows' ε (n_val,
    zdim)) in place of the run's own (a test feeds the JAX trainer's). group:
    this rank's parallel.DataGroup (see the module docstring)."""
    device = resolve_device(str(device))
    set_float32_precision(config.compute_dtype)
    writer = group is None or group.global_rank == 0
    own_log = log is None
    log = log or (MetricsLogger(config.outdir) if writer else NullLogger())
    outdir = config.outdir if writer else None
    run_key, init_key, _ = prng.split(prng.PRNGKey(config.seed), 3)
    model = vae_from_record(vars(config), dataset.image_shape, key=init_key)
    if init_params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
    model.to(device)
    replicate(group, model.parameters())
    opt = torch.optim.Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)

    train_idx = torch.from_numpy(dataset.train_idx.astype("int64"))
    val_idx = torch.from_numpy(dataset.val_idx.astype("int64"))
    n, bs = len(train_idx), config.batch_size
    nb = num_batches(n, bs)
    draws = draws or _make_draws(run_key, n, bs, config.zdim, len(val_idx))
    if group is None:
        images = torch.from_numpy(dataset.images).to(device)
        train_idx, val_idx = train_idx.to(device), val_idx.to(device)
    else:
        block = row_block(len(dataset.images), group)
        images = torch.from_numpy(dataset.images[block]).to(device)
    val_config = dataclasses.replace(config, sat_penalty=0.0)
    panel_rows = torch.from_numpy(dataset.images[
        (dataset.val_idx if len(dataset.val_idx) else dataset.train_idx)[:8]]).to(device)

    history: list[dict] = []
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        batches, weights, eps, eps_v = draws(epoch)
        rows = []
        if group is None:
            batches, weights, eps = batches.to(device), weights.to(device), eps.to(device)
            for b in range(nb):
                y = images[train_idx[batches[b]]]
                loss, aux = vae_loss(model, y, eps[b], weights[b], config)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                rows.append(torch.stack([loss.detach(), *aux]))
        else:
            for b in range(nb):
                own, local = _owned_rows(train_idx[batches[b]], block)
                opt.zero_grad(set_to_none=True)
                s = _reduced_sums(model, images[local.to(device)], eps[b][own].to(device),
                                  weights[b][own].to(device), config, group, backward=True)
                opt.step()
                rows.append(torch.cat([s[:1], s[1:4] / s[4]]))
        row = torch.stack(rows).mean(dim=0).tolist()
        rec = {"driver": "train_vae", "epoch": epoch,
               **dict(zip(("loss", "recon_term", "kl_term", "mse"), row))}
        if len(val_idx):
            with torch.no_grad():
                # the val mean of recon + β·KL, without the saturation
                # barrier (as the JAX trainer reports it)
                if group is None:
                    loss_v, (_, _, mse_v) = vae_loss(
                        model, images[val_idx], eps_v.to(device),
                        torch.ones(len(val_idx), device=device), val_config)
                else:
                    own, local = _owned_rows(val_idx, block)
                    s = _reduced_sums(model, images[local.to(device)], eps_v[own].to(device),
                                      torch.ones(int(own.sum()), device=device), val_config,
                                      group, backward=False)
                    loss_v, mse_v = (s[1] + config.beta_kl * s[2]) / s[4], s[3] / s[4]
            rec["val_loss"], rec["val_mse"] = float(loss_v), float(mse_v)
        rec["sec_epoch"] = time.perf_counter() - t0
        log.log(rec)
        history.append(rec)
        if outdir:
            _epoch_artifacts(model, panel_rows, config, epoch,
                             prng.fold_in(prng.fold_in(run_key, epoch), 3))

    if outdir:
        _save_weights(model, os.path.join(config.outdir, WEIGHTS_FILE))
        save_tree(os.path.join(config.outdir, "final_state"),
                  {"vae": model.state_dict(), "opt": opt.state_dict(), "epoch": config.epochs})
    if own_log:
        log.close()
    return VAETrainResult(model=model, config=config, history=history)


def _make_draws(run_key, n: int, bs: int, zdim: int, n_val: int) -> Callable:
    """draws(epoch) → (batches, weights, ε, the validation rows' ε) of the
    JAX trainer's epoch (train_vae.py:115, :146, :157)."""
    gppvae_draws = make_draws(run_key, n, bs, zdim)

    def draws(epoch: int):
        eps_v = prng.normal(prng.fold_in(prng.fold_in(run_key, epoch), 2), (n_val, zdim))
        return (*gppvae_draws(epoch), torch.from_numpy(eps_v))

    return draws


def _save_weights(model: VAE, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def _epoch_artifacts(model: VAE, y: torch.Tensor, config: VAETrainConfig, epoch: int,
                     key) -> None:
    """panel_NNNN.png (the rows `y` over their reconstructions, ε from
    `key`) and vae_weights_NNNN.pt (train_vae.py:267-280)."""
    last = epoch == config.epochs - 1
    if config.panel_every and (epoch % config.panel_every == 0 or last):
        recon = sample_reconstruction(model, y, key)
        save_panel(os.path.join(config.outdir, f"panel_{epoch:04d}.png"),
                   [y.cpu().numpy(), recon.cpu().numpy()])
    if config.checkpoint_every and epoch % config.checkpoint_every == 0 and not last:
        _save_weights(model, os.path.join(config.outdir, f"vae_weights_{epoch:04d}.pt"))


def main(argv=None) -> VAETrainResult:
    import argparse

    p = argparse.ArgumentParser(description="Vanilla conv-VAE pretrain (GPPVAE stage 1)")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | sklearn | mnist:<dir> | faces[:h5:<path>] | npz:<path>")
    p.add_argument("--outdir", default="./out/vae")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_y", type=float, default=0.1)
    p.add_argument("--beta_kl", type=float, default=1.0)
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    add_arch_flags(p, dtype_help="VAE compute dtype (params stay float32)",
                   layout_help="port or facevae (models/vae.py); pass train_gppvae the same")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--panel_every", type=int, default=10,
                   help="epochs between panel_NNNN.png (0 = off)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="epochs between vae_weights_NNNN.pt checkpoints (0 = end only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ds = build_dataset_from_flag(args.data, args.num_objects, args.num_views,
                                 args.seed, image_size=args.image_size)
    config = VAETrainConfig(
        epochs=args.epochs, batch_size=args.bs, lr=args.lr, seed=args.seed,
        sigma_y=args.sigma_y, beta_kl=args.beta_kl, **arch_from_flags(args),
        outdir=args.outdir, panel_every=args.panel_every,
        checkpoint_every=args.checkpoint_every,
    )
    return train_vae(ds, config, device=device)


if __name__ == "__main__":
    main()
