"""Out-of-sample conditional generation CLI.

Counterpart of gppvae_tpu/eval/generate.py. Loads a finished train_gppvae
run (its final_params.pt, with config.json beside it), encodes the training
rows with the saved encoder, and generates images for the held-out
(object, view) cells from GP-predictive latents alone, reporting the pixel
MSE and writing a truth / prediction panel:

    python -m gppvae_tpu_torch generate --state out/gppvae/final_params.pt

Other modes:
    --object D    every view of object D, predicted from its training views
    --sample K    K draws from the learned GP prior z = U ε_r + √v_n ε_n
    --posterior_sample K --object D --view V [--joint]
                  K draws from the GP-predictive posterior of one cell, or
                  jointly over object D's whole view sweep
    --export_server PATH
                  fold the posterior into the R-sized serving artifact
                  (eval/serving.py), with the RFF draws and landmarks

The model is built in the run's compute dtype (bfloat16 for a bfloat16 run,
with or without a float32 polish tail) and decoder, as the JAX package
builds it. Random draws are the JAX package's (utils/prng.py) from
PRNGKey(--draw_seed), else PRNGKey(the run's seed); each function also
takes injected draws.
The object kernel's RFF draws and landmarks come from final_params.pt, not
from the seed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gppvae_tpu_torch import gp
from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.eval.oos import predict_heldout
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.eval.serving import (
    build_server_state,
    decode_images,
    save_server_state,
    stable_cholesky,
)
from gppvae_tpu_torch.models import VAE, encode_all
from gppvae_tpu_torch.train.device import compute_dtype as _dtype
from gppvae_tpu_torch.train.device import resolve_device, set_float32_precision
from gppvae_tpu_torch.utils import prng


def _params(state: dict) -> dict:
    return {"vae": state["vae"], "gp": state["gp"]}


def _rff_draws(state: dict):
    """(Ω, b) of the run's object kernel, or None (linear kernel)."""
    ok = state.get("object_kernel")
    return None if ok is None else (ok["omega"], ok["phase"])


def _device(state: dict) -> torch.device:
    return state["gp"]["X"].device


def _rows(dataset: GridDataset, idx, device) -> tuple:
    """(images, object ids, view ids) of rows `idx` as tensors on device."""
    def ids(a):
        return torch.as_tensor(np.asarray(a[idx]), dtype=torch.int64, device=device)

    return (torch.from_numpy(dataset.images[idx]).to(device), ids(dataset.object_ids),
            ids(dataset.view_ids))


def _key(seed: int, draw_seed: int | None):
    return prng.PRNGKey(seed if draw_seed is None else draw_seed)


def _check_grid_matches(params, fixed_W, dataset: GridDataset) -> None:
    """Loud error when the rebuilt dataset's grid does not match the
    checkpoint (a wrong grid would fold a silently wrong posterior)."""
    P = params["gp"]["X"].shape[0]
    W = params["gp"]["W"] if "W" in params["gp"] else fixed_W
    Q = None if W is None else W.shape[0]
    if dataset.num_objects != P or (Q is not None and dataset.num_views != Q):
        raise ValueError(
            f"dataset grid ({dataset.num_objects} objects × "
            f"{dataset.num_views} views) does not match the checkpoint "
            f"({P} objects × {Q} views) — pass the same --data/--num_objects/"
            "--num_views the run was trained with"
        )


def _model_and_xmap(state: dict, dataset: GridDataset, *, zdim, enc_features, dec_features,
                    object_kernel, rff_lengthscale, dec_upsample="resize",
                    compute_dtype="float32", **_ignored):
    """Checkpoint → (model holding the run's VAE weights, on the state's
    device; object-kernel map), with the grid-mismatch guard. The model
    computes in the run's compute_dtype through its decoder lowering."""
    _check_grid_matches(_params(state), state.get("fixed_W"), dataset)
    ok = state.get("object_kernel") or {}
    x_map = gp.make_x_map(object_kernel, _rff_draws(state), rff_lengthscale,
                          ok.get("nystrom_idx"))
    model = VAE(zdim, dataset.image_shape, tuple(enc_features), tuple(dec_features),
                dec_upsample, dtype=_dtype(compute_dtype))
    model.load_state_dict(state["vae"])
    return model.to(_device(state)), x_map


@torch.no_grad()
def generate_heldout(state: dict, dataset: GridDataset, *, extra_effects: tuple = (),
                     **arch) -> tuple[np.ndarray, float]:
    """(predicted held-out images, pixel MSE against the truth)."""
    model, x_map = _model_and_xmap(state, dataset, **arch)
    device = _device(state)
    images_tr, d_tr, q_tr = _rows(dataset, dataset.train_idx, device)
    y_ho, d_ho, q_ho = _rows(dataset, dataset.heldout_idx, device)
    Z0 = encode_all(model, images_tr, min(1024, len(dataset.train_idx)))
    y_pred, mse = predict_heldout(model, state["gp"], state.get("fixed_W"), Z0, d_tr, q_tr,
                                  d_ho, q_ho, y_ho, x_map=x_map,
                                  extra_effects=tuple(extra_effects))
    return y_pred.cpu().numpy(), float(mse)


@torch.no_grad()
def synthesize_views(state: dict, dataset: GridDataset, object_id: int, *,
                     extra_effects: tuple = (), **arch) -> np.ndarray:
    """Novel-view synthesis: GP-predict every view of one object from the
    training rows only (its held-out views are extrapolated)."""
    if not 0 <= object_id < dataset.num_objects:
        raise ValueError(f"object {object_id} out of range [0, {dataset.num_objects})")
    model, x_map = _model_and_xmap(state, dataset, **arch)
    device = _device(state)
    images_tr, d_tr, q_tr = _rows(dataset, dataset.train_idx, device)
    Q = dataset.num_views
    d_all = torch.full((Q,), object_id, dtype=torch.int64, device=device)
    q_all = torch.arange(Q, device=device)
    Z0 = encode_all(model, images_tr, min(1024, len(dataset.train_idx)))
    y_pred, _ = predict_heldout(
        model, state["gp"], state.get("fixed_W"), Z0, d_tr, q_tr, d_all, q_all,
        torch.zeros((Q, *dataset.image_shape), device=device),
        x_map=x_map, extra_effects=tuple(extra_effects))
    return y_pred.cpu().numpy()


@torch.no_grad()
def sample_prior(state: dict, dataset: GridDataset, num_samples: int, *, zdim: int,
                 extra_effects: tuple = (), seed: int = 0, draw_seed: int | None = None,
                 draws: dict | None = None, **arch) -> np.ndarray:
    """Unconditional generation from the learned GP prior: latent rows
    z = U ε_r + √v_n ε_n for random (object, view) cells, decoded.

    draw_seed seeds the draws alone (default: `seed`). draws: {'d', 'q'
    (num_samples,), 'eps_r' (R, zdim), 'eps_n' (num_samples, zdim)} in place
    of the JAX package's (generate.py:216-230: four keys split from the
    seed's, for d, q, ε_r and ε_n)."""
    model, x_map = _model_and_xmap(state, dataset, zdim=zdim, **arch)
    device = _device(state)
    kd, kq, kr, kn = prng.split(_key(seed, draw_seed), 4)
    if draws is None:
        draws = {"d": prng.randint(kd, (num_samples,), 0, dataset.num_objects),
                 "q": prng.randint(kq, (num_samples,), 0, dataset.num_views)}
    d = torch.as_tensor(np.asarray(draws["d"]), dtype=torch.int64, device=device)
    q = torch.as_tensor(np.asarray(draws["q"]), dtype=torch.int64, device=device)
    p = state["gp"]
    W = p["W"] if "W" in p else state.get("fixed_W")
    Vs = gp.build_effect_rows(p["X"], W, d, q, extra_effects=tuple(extra_effects), x_map=x_map)
    v_sig, v_noise = gp.variances_from_log(p["log_vs"], p["log_vn"])
    v_sig = v_sig.reshape(-1)
    U = gp.scaled_features(Vs, [v_sig[i] for i in range(len(Vs))])
    eps_r = draws.get("eps_r")
    eps_r = prng.normal(kr, (U.shape[1], zdim)) if eps_r is None else eps_r
    eps_n = draws.get("eps_n")
    eps_n = prng.normal(kn, (num_samples, zdim)) if eps_n is None else eps_n
    z = (U @ torch.as_tensor(eps_r, dtype=U.dtype).to(device)
         + torch.sqrt(v_noise) * torch.as_tensor(eps_n, dtype=U.dtype).to(device))
    return torch.sigmoid(model.decode(z)).cpu().numpy()


def _posterior_scaffold(state: dict, dataset: GridDataset, d_star, q_star, *,
                        extra_effects: tuple = (), **arch):
    """The part sample_posterior and sample_posterior_sweep share: the
    model rebuild with the grid guard, the encode of the training rows and
    the Woodbury factorization. Returns (model, Z0, V_star, v_sigs,
    factors)."""
    model, x_map = _model_and_xmap(state, dataset, **arch)
    device = _device(state)
    images_tr, d_tr, q_tr = _rows(dataset, dataset.train_idx, device)
    p = state["gp"]
    W = p["W"] if "W" in p else state.get("fixed_W")
    v_sig, v_noise = gp.variances_from_log(p["log_vs"], p["log_vn"])
    v_sig = v_sig.reshape(-1)
    Z0 = encode_all(model, images_tr, min(1024, len(dataset.train_idx)))
    extra = tuple(extra_effects)
    V_tr = gp.build_effect_rows(p["X"], W, d_tr, q_tr, extra_effects=extra, x_map=x_map)
    V_star = gp.build_effect_rows(p["X"], W, d_star.to(device), q_star.to(device),
                                  extra_effects=extra, x_map=x_map)
    v_sigs = [v_sig[i] for i in range(len(V_tr))]
    return model, Z0, V_star, v_sigs, gp.factorize(V_tr, v_sigs, v_noise)


@torch.no_grad()
def sample_posterior(state: dict, dataset: GridDataset, object_id: int, view_id: int,
                     num_samples: int, *, seed: int = 0, draw_seed: int | None = None,
                     eps=None, **arch) -> tuple[np.ndarray, float]:
    """K decoded draws z* ~ N(μ*, σ*² I_L) from the GP-predictive posterior
    of one (object, view) cell. eps (K, L) replaces the draws from the
    seed's key.
    Returns (images (K, H, W, C), posterior variance σ*²)."""
    if not 0 <= object_id < dataset.num_objects:
        raise ValueError(f"object {object_id} out of range [0, {dataset.num_objects})")
    if not 0 <= view_id < dataset.num_views:
        raise ValueError(f"view {view_id} out of range [0, {dataset.num_views})")
    model, Z0, V_star, v_sigs, factors = _posterior_scaffold(
        state, dataset, torch.tensor([object_id]), torch.tensor([view_id]), seed=seed, **arch)
    mean, var = gp.predict_latents(V_star, factors, Z0, v_sigs, return_var=True)
    if eps is None:
        eps = prng.normal(_key(seed, draw_seed), (num_samples, mean.shape[1]))
    z = mean + torch.sqrt(torch.clamp(var[:, None], min=0.0)) * torch.as_tensor(
        eps, dtype=mean.dtype).to(mean.device)
    return torch.sigmoid(model.decode(z)).cpu().numpy(), float(var[0])


@torch.no_grad()
def sample_posterior_sweep(state: dict, dataset: GridDataset, object_id: int,
                           num_samples: int, *, seed: int = 0, draw_seed: int | None = None,
                           jitter: float = 1e-6, eps=None, **arch) -> tuple[np.ndarray, np.ndarray]:
    """K joint draws of one object's whole view sweep from the exact Q×Q
    posterior covariance (gp.predict_cov_from_core), so that each draw is
    one coherent object seen from every view. eps (Q, K, L) replaces the
    draws from the seed's key. Returns (images (K, Q, H, W, C), per-view posterior
    variance (Q,))."""
    if not 0 <= object_id < dataset.num_objects:
        raise ValueError(f"object {object_id} out of range [0, {dataset.num_objects})")
    Q = dataset.num_views
    model, Z0, V_star, v_sigs, factors = _posterior_scaffold(
        state, dataset, torch.full((Q,), object_id), torch.arange(Q), seed=seed, **arch)
    mean, cov = gp.predict_cov_from_core(V_star, gp.posterior_core(factors, Z0), v_sigs)
    L = mean.shape[1]
    if eps is None:
        eps = prng.normal(_key(seed, draw_seed), (Q, num_samples, L))
    z = mean[:, None, :] + torch.einsum(
        "ij,jkl->ikl", stable_cholesky(cov, jitter),
        torch.as_tensor(eps, dtype=mean.dtype).to(mean.device))
    y = decode_images(model, state["vae"], z.reshape(Q * num_samples, L))
    y = y.reshape(Q, num_samples, *y.shape[1:])
    return y.transpose(0, 1).cpu().numpy(), torch.diagonal(cov).cpu().numpy()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="GPPVAE out-of-sample generation")
    p.add_argument("--state", required=True,
                   help="final_params.pt of a train_gppvae run (config.json beside it)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # dataset flags default from the run's config.json, so that the data
    # and split evaluated are the ones the run trained on
    p.add_argument("--data", default=None)
    p.add_argument("--image_size", type=int, default=None,
                   help="spatial size for built datasets (defaults from the"
                        " sidecar; builder default otherwise)")
    p.add_argument("--num_objects", type=int, default=None)
    p.add_argument("--num_views", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--zdim", type=int, default=None)
    p.add_argument("--object", type=int, default=None,
                   help="synthesize ALL views of this object id")
    p.add_argument("--sample", type=int, default=0,
                   help="decode N draws from the learned GP prior")
    p.add_argument("--posterior_sample", type=int, default=0,
                   help="with --object/--view: decode N draws from the "
                        "GP-predictive POSTERIOR of that cell")
    p.add_argument("--view", type=int, default=0,
                   help="view id for --posterior_sample (default 0)")
    p.add_argument("--draw_seed", type=int, default=None,
                   help="RNG seed for --sample/--posterior_sample draws only "
                        "(default: the run's training seed)")
    p.add_argument("--joint", action="store_true",
                   help="with --posterior_sample --object: draw the K samples "
                        "jointly over the object's full view sweep from the "
                        "exact Q×Q posterior covariance (--view is ignored)")
    p.add_argument("--export_server", default=None, metavar="PATH",
                   help="fold the GP posterior into an R-sized server state "
                        "(eval/serving.py) and save the deployment artifact")
    p.add_argument("--outdir", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision("float32")

    # the model architecture from the run's config.json, --zdim overriding
    run_dir = os.path.dirname(os.path.abspath(args.state))
    arch = {
        "zdim": 16, "enc_features": (32, 64, 128),
        "dec_features": (128, 64, 32), "object_kernel": "linear",
        "rff_features": 32, "rff_lengthscale": 1.0, "extra_effects": (),
        "seed": 0, "dec_upsample": "resize", "compute_dtype": "float32",
    }
    cfg_path = os.path.join(run_dir, "config.json")
    saved = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f)
        arch.update({k: saved[k] for k in arch if k in saved})
    if args.zdim is not None:
        arch["zdim"] = args.zdim

    saved_ds = saved.get("dataset", {})
    data = args.data if args.data is not None else saved.get("data") or "synthetic"
    num_objects = (args.num_objects if args.num_objects is not None
                   else saved_ds.get("num_objects", 400))
    num_views = args.num_views if args.num_views is not None else saved_ds.get("num_views", 16)
    seed = args.seed if args.seed is not None else saved.get("seed", 0)
    image_size = args.image_size if args.image_size is not None else saved_ds.get("image_size")

    ds = build_dataset_from_flag(data, num_objects, num_views, seed, image_size=image_size)
    state = torch.load(args.state, map_location=device, weights_only=True)
    outdir = args.outdir or run_dir

    if args.export_server:
        # _model_and_xmap applies the grid-mismatch guard here too
        model, x_map = _model_and_xmap(state, ds, **arch)
        images_tr, d_tr, q_tr = _rows(ds, ds.train_idx, device)
        srv = build_server_state(model, _params(state), state.get("fixed_W"), images_tr,
                                 d_tr, q_tr, x_map=x_map,
                                 extra_effects=tuple(arch["extra_effects"]))
        # record how to rebuild the feature map and the model at serve time
        save_server_state(
            args.export_server, srv, meta={**arch, "image_shape": tuple(ds.image_shape)},
            nystrom_idx=(state.get("object_kernel") or {}).get("nystrom_idx"),
            rff_draws=_rff_draws(state),
        )
        print(json.dumps({
            "server_state": os.path.abspath(args.export_server),
            "rank": int(srv.core.M.shape[0]), "zdim": int(srv.core.M.shape[1]),
        }))
        return
    if args.joint and not args.posterior_sample:
        raise SystemExit("--joint modifies --posterior_sample; pass "
                         "--posterior_sample K --object D")
    if args.posterior_sample:
        if args.object is None:
            raise SystemExit("--posterior_sample needs --object (and --view)")
        if args.joint:
            y_s, var = sample_posterior_sweep(state, ds, args.object, args.posterior_sample,
                                              draw_seed=args.draw_seed, **arch)
            sel = ds.object_ids == args.object
            truth = ds.images[sel.nonzero()[0]][np.argsort(ds.view_ids[sel])]
            path = os.path.join(outdir, f"posterior_sweep_obj{args.object}.png")
            # one panel row per joint draw: a coherent scene across views
            save_panel(path, ([truth] if len(truth) else []) + [y_s[k] for k in range(len(y_s))])
            print(json.dumps({
                "posterior_sweep_panel": path, "object": args.object,
                "n": int(args.posterior_sample),
                "posterior_var": [round(float(v), 6) for v in var],
            }))
            return
        y_s, var = sample_posterior(state, ds, args.object, args.view, args.posterior_sample,
                                    draw_seed=args.draw_seed, **arch)
        cell = np.where((ds.object_ids == args.object) & (ds.view_ids == args.view))[0]
        path = os.path.join(outdir, f"posterior_obj{args.object}_view{args.view}.png")
        # save_panel cuts every row to the shortest: tile the one truth
        # image across the K sample columns so that all K draws show
        rows = ([np.repeat(ds.images[cell[:1]], len(y_s), axis=0)] if len(cell) else []) + [y_s]
        save_panel(path, rows)
        print(json.dumps({
            "posterior_panel": path, "object": args.object, "view": args.view,
            "n": int(args.posterior_sample), "posterior_var": var,
        }))
        return
    if args.object is not None:
        y_views = synthesize_views(state, ds, args.object, **arch)
        truth = ds.images[args.object * ds.num_views:(args.object + 1) * ds.num_views]
        path = os.path.join(outdir, f"views_obj{args.object}.png")
        save_panel(path, [truth, y_views])
        print(json.dumps({"views_panel": path, "object": args.object}))
        return
    if args.sample:
        y_s = sample_prior(state, ds, args.sample, draw_seed=args.draw_seed, **arch)
        path = os.path.join(outdir, "prior_samples.png")
        save_panel(path, [y_s])
        print(json.dumps({"samples_panel": path, "n": int(args.sample)}))
        return

    y_pred, mse = generate_heldout(state, ds, **arch)
    print(json.dumps({"heldout_mse": mse, "n_heldout": len(ds.heldout_idx)}))
    save_panel(os.path.join(outdir, "oos_panel.png"),
               [ds.images[ds.heldout_idx[:12]], y_pred[:12]])


if __name__ == "__main__":
    main()
