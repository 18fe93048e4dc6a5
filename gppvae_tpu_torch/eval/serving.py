"""Serving path for conditional generation: fold once, decode per request.

Counterpart of gppvae_tpu/eval/serving.py (see its docstring for the
design). A deployed model answers many (object, view) requests against one
trained state, so everything N-sized is folded into the R-sized posterior
core once (gp.posterior_core):

    build_server_state: one full encode + one Woodbury factorization + one
        K⁻¹Z solve → ServerState{core (R×L, R×R), X, W, variances, VAE
        params}; O(N·R²) once, and the state is independent of N.
    predict_images: per request, the feature rows of the asked (object,
        view) pairs, z* = U*·M, decode; optionally the GP-predictive
        latent variance per row.
    sample_images / observe: posterior draws (independent or joint over the
        request batch) and streaming conditioning on new observed images.

`vae_params` in the state is the VAE's state_dict; the model passed to each
function gives the architecture and compute dtype, and its halves run on the
state's tensors (torch.func.functional_call), as the JAX functions apply
`model` to `state.vae_params`. Random draws come from an explicit
torch.Generator on the CPU (the same draws on every device), or are
injected (`eps`). The device is the state's: nothing here moves a tensor to
the CPU except where a reply is written.

The artifact (`save_server_state`) also carries the object kernel's RFF
draws Ω, b: the JAX package rebuilds them from the training seed through
threefry (serving.py:617-624), which torch cannot reproduce, so an rbf
model served without them would get another kernel.

The compiled-program surface of the JAX package (`serve --exe`,
`--export_exe`, jax.export blobs) is not ported yet (ROADMAP).
"""

from __future__ import annotations

import json
import os
import sys
import time
import zipfile
from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from gppvae_tpu_torch import gp
from gppvae_tpu_torch.checkpoint import load_tree, save_tree
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.train.device import compute_dtype, resolve_device, set_float32_precision


class ServerState(NamedTuple):
    """What a server holds per trained model (N-independent)."""

    core: gp.PosteriorCore  # (R,L) mean core + (R,R) variance factors
    X: torch.Tensor  # (P, M) object features
    W: torch.Tensor  # (Q, M_w) view features (learned or fixed)
    v_sig: torch.Tensor  # (n_eff,) signal variances
    vae_params: dict  # the VAE's state_dict (encoder and decoder)


def _part(vae_params: dict, name: str) -> dict:
    pre = name + "."
    return {k[len(pre):]: v for k, v in vae_params.items() if k.startswith(pre)}


def _encode_all(model, vae_params: dict, images: torch.Tensor, chunk: int) -> torch.Tensor:
    """Latent means of every row, `chunk` rows at a time, with the encoder
    run on `vae_params` (models.encode_all on the state's weights)."""
    enc = _part(vae_params, "encoder")
    return torch.cat([functional_call(model.encoder, enc, (images[s:s + chunk],))[0]
                      for s in range(0, images.shape[0], chunk)])


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _effect_rows(state: ServerState, d, q, *, x_map, extra_effects) -> tuple[list, list]:
    """(feature rows, their signal variances) of the requested rows; raises
    when extra_effects builds another number of effects than the state
    carries variances (the rows pair with v_sig by position only)."""
    V = gp.build_effect_rows(state.X, state.W, d, q, extra_effects=extra_effects, x_map=x_map)
    if len(V) != state.v_sig.shape[0]:
        raise ValueError(
            f"extra_effects={extra_effects!r} builds {len(V)} effect(s) "
            f"but the server state carries {state.v_sig.shape[0]} variance(s); "
            "pass the extra_effects recorded in the artifact's meta"
        )
    return V, [state.v_sig[i] for i in range(len(V))]


@torch.no_grad()
def build_server_state(model, params: dict, fixed_W, images_tr: torch.Tensor,
                       d_tr: torch.Tensor, q_tr: torch.Tensor, *, x_map=None,
                       extra_effects: tuple = (), encode_chunk: int = 1024) -> ServerState:
    """Fold the training set into the R-sized posterior core: the
    grad-free full encode, the factorization of K = Σ_r v_r V_r V_rᵀ + v_n I
    and the K⁻¹Z core, once. params: {'vae': state_dict, 'gp': {'X', ['W'],
    'log_vs', 'log_vn', ...}}; fixed_W is the 'dis'-mode view matrix."""
    W = params["gp"]["W"] if "W" in params["gp"] else fixed_W
    X = params["gp"]["X"]
    Z0 = _encode_all(model, params["vae"], images_tr, min(encode_chunk, images_tr.shape[0]))
    V_tr = gp.build_effect_rows(X, W, d_tr, q_tr, extra_effects=extra_effects, x_map=x_map)
    v_sig, v_noise = gp.variances_from_log(params["gp"]["log_vs"], params["gp"]["log_vn"])
    v_sig = v_sig.reshape(-1)
    factors = gp.factorize(V_tr, [v_sig[i] for i in range(len(V_tr))], v_noise)
    # the encoder returns float32 latents whatever the GP's dtype
    return ServerState(core=gp.posterior_core(factors, Z0.to(factors.U.dtype)), X=X, W=W,
                       v_sig=v_sig,
                       vae_params=params["vae"])


@torch.no_grad()
def decode_images(model, vae_params: dict, z: torch.Tensor, chunk: int | None = 512) -> torch.Tensor:
    """sigmoid(decode(z)) in chunks of at most `chunk` rows (None: one
    forward), which bounds the activations of a large joint sample; the
    chunks give the rows a single forward gives. Latents and images are
    float32 whatever the model's compute dtype."""
    dec = _part(vae_params, "decoder")
    n = z.shape[0]
    step = n if chunk is None or n <= chunk else chunk
    return torch.cat([torch.sigmoid(functional_call(model.decoder, dec, (z[s:s + step],)))
                      for s in range(0, n, step)])


@torch.no_grad()
def predict_images(model, state: ServerState, d: torch.Tensor, q: torch.Tensor, *,
                   x_map=None, extra_effects: tuple = (), return_var: bool = False):
    """Serve one request batch: images (n, H, W, C) for the (object, view)
    index vectors, O(R) GP work per row and one decoder forward; with
    return_var=True also the (n,) GP-predictive latent variance."""
    V_star, v_sigs = _effect_rows(state, d, q, x_map=x_map, extra_effects=extra_effects)
    out = gp.predict_from_core(V_star, state.core, v_sigs, return_var=return_var)
    z_star, var = out if return_var else (out, None)
    y = decode_images(model, state.vae_params, z_star, chunk=None)
    return (y, var) if return_var else y


def stable_cholesky(cov: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """Cholesky of (C + Cᵀ)/2 plus a scale-relative jitter: jitter ×
    max(1, mean(diag)) on the diagonal, since the roundoff of U*B⁻¹U*ᵀ grows
    with the core's scale and an absolute jitter can sit below it when
    request rows repeat."""
    cov = 0.5 * (cov + cov.T)
    scale = torch.clamp(torch.mean(torch.diagonal(cov)), min=1.0)
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky(cov + (jitter * scale) * eye)


def _normal(generator, shape, like: torch.Tensor, eps=None) -> torch.Tensor:
    """Standard normal draws of `shape` from the CPU `generator`, or the
    injected `eps`, on like's device and dtype."""
    if eps is None:
        eps = torch.randn(shape, generator=generator, dtype=torch.float32)
    elif not torch.is_tensor(eps):
        eps = torch.tensor(np.asarray(eps))
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"eps of shape {tuple(eps.shape)}; want {tuple(shape)}")
    return eps.to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def sample_images(model, state: ServerState, d: torch.Tensor, q: torch.Tensor,
                  generator: torch.Generator | None, num_samples: int, *, x_map=None,
                  extra_effects: tuple = (), joint: bool = False, jitter: float = 1e-6,
                  decode_chunk: int | None = 512, eps=None) -> torch.Tensor:
    """K decoded posterior draws per requested row, (n, K, H, W, C).

    Independent: z ~ N(μ*, σ*² I_L) per row from the diagonal variance.
    joint=True: coherent draws over the whole request batch from the full
    n×n posterior covariance (gp.predict_cov_from_core), z[:, k, l] =
    μ[:, l] + L_c ε[:, k, l], so rows of one object vary together.
    eps (n, K, L) replaces the draws from `generator`."""
    V_star, v_sigs = _effect_rows(state, d, q, x_map=x_map, extra_effects=extra_effects)
    if joint:
        mean, cov = gp.predict_cov_from_core(V_star, state.core, v_sigs)
        n, L = mean.shape
        e = _normal(generator, (n, num_samples, L), mean, eps)
        z = mean[:, None, :] + torch.einsum("ij,jkl->ikl", stable_cholesky(cov, jitter), e)
    else:
        mean, var = gp.predict_from_core(V_star, state.core, v_sigs, return_var=True)
        n, L = mean.shape
        e = _normal(generator, (n, num_samples, L), mean, eps)
        z = mean[:, None, :] + torch.sqrt(torch.clamp(var, min=0.0))[:, None, None] * e
    y = decode_images(model, state.vae_params, z.reshape(n * num_samples, L), decode_chunk)
    return y.reshape(n, num_samples, *y.shape[1:])


@torch.no_grad()
def observe(model, state: ServerState, images: torch.Tensor, d: torch.Tensor,
            q: torch.Tensor, *, x_map=None, extra_effects: tuple = (),
            encode_chunk: int = 1024, row_mask: torch.Tensor | None = None) -> ServerState:
    """Fold new observed images into the serving posterior (streaming
    conditioning): encode them, build their feature rows from the state's
    X, W and extend the core (gp.extend_posterior_core), O(n·R² + R³). The
    same state build_server_state gives with these rows in the training
    set; the GP and VAE parameters stay fixed. row_mask (n,) ∈ {0, 1}:
    weight-0 rows contribute nothing (their feature rows are zeroed)."""
    V_new, v_sigs = _effect_rows(state, d, q, x_map=x_map, extra_effects=extra_effects)
    if row_mask is not None:
        m = row_mask.to(V_new[0].dtype)[:, None]
        V_new = [v * m for v in V_new]
    Z_new = _encode_all(model, state.vae_params, images, min(encode_chunk, images.shape[0]))
    return state._replace(core=gp.extend_posterior_core(state.core, V_new, v_sigs, Z_new))


def _meta_path(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path)) + ".meta.json"


def save_server_state(path: str, state: ServerState, meta: dict | None = None,
                      nystrom_idx=None, rff_draws=None) -> None:
    """Persist the folded state (the deployment artifact, O(R²) + params):
    the tensors through checkpoint.save_tree, and `meta` (object kernel,
    rff_features / lengthscale, extra_effects, the model's architecture,
    image shape, compute dtype, decoder) as the JSON sidecar
    `<path>.meta.json`. The object kernel's tensors ride in the tree:
    `nystrom_idx` (rbf-nystrom landmarks) and `rff_draws` (Ω, b)."""
    tree = {**state._asdict(), "core": state.core._asdict()}
    if nystrom_idx is not None:
        tree["nystrom_idx"] = torch.as_tensor(nystrom_idx)
    if rff_draws is not None:
        tree["rff_draws"] = {"omega": rff_draws[0], "phase": rff_draws[1]}
    save_tree(path, tree)
    with open(_meta_path(path), "w") as f:
        json.dump(meta or {}, f, indent=1, default=list)


def load_server_state(path: str, *, allow_missing_meta: bool = False,
                      map_location=None) -> tuple[ServerState, dict]:
    """(state, meta), the tensors on `map_location` (default: the CPU).
    meta gains the tree's 'nystrom_idx' and 'rff_draws' (Ω, b) where the
    artifact has them; x_map_from_meta rebuilds the feature map from it.

    Fails loudly when the `.meta.json` sidecar is missing: without it an
    rbf artifact would be served with the linear map, wrong whenever the
    ranks coincide. allow_missing_meta=True opts back in."""
    tree = dict(load_tree(path, map_location=map_location))
    core = gp.PosteriorCore(**tree.pop("core"))
    extras = {k: tree.pop(k) for k in ("nystrom_idx", "rff_draws") if k in tree}
    meta = {}
    meta_path = _meta_path(path)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    elif not allow_missing_meta:
        raise FileNotFoundError(
            f"server-state sidecar {meta_path} not found: it records the "
            "feature-map config (object_kernel, rff rank, extra_effects) "
            "needed to serve this artifact correctly. Restore it next to the "
            "checkpoint, or pass allow_missing_meta=True to serve with "
            "all-default settings at your own risk."
        )
    if "nystrom_idx" in extras:
        meta["nystrom_idx"] = extras["nystrom_idx"]
    if "rff_draws" in extras:
        meta["rff_draws"] = (extras["rff_draws"]["omega"], extras["rff_draws"]["phase"])
    return ServerState(core=core, **tree), meta


def _resave(path: str, state: ServerState, meta: dict) -> None:
    """save_server_state with load_server_state's meta: the tensors it
    added go back into the tree."""
    save_server_state(path, state,
                      meta={k: v for k, v in meta.items() if k not in ("nystrom_idx", "rff_draws")},
                      nystrom_idx=meta.get("nystrom_idx"), rff_draws=meta.get("rff_draws"))


def x_map_from_meta(meta: dict, in_dim: int):
    """The object-kernel feature map an artifact was exported with
    (gp.make_x_map over the recorded kind, lengthscale, the carried RFF
    draws and landmarks; None for the linear kernel)."""
    draws = meta.get("rff_draws")
    if draws is not None and draws[0].shape[0] != in_dim:
        raise ValueError(f"the artifact's RFF draws map {draws[0].shape[0]} object features; "
                         f"its X has {in_dim}")
    return gp.make_x_map(meta.get("object_kernel", "linear"), draws,
                         meta.get("rff_lengthscale", 1.0), meta.get("nystrom_idx"))


def _load_observation_npz(path: str, P: int, Q: int, image_shape, err=ValueError):
    """Load and validate an observation npz (images + objects/views, or
    GridDataset's object_ids/view_ids). `err` picks the error type:
    SystemExit at CLI entry points, ValueError where the caller reports and
    goes on (the stdin loop)."""
    with np.load(path, allow_pickle=False) as f:
        keys = set(f.files)
        try:
            imgs = np.asarray(f["images"], np.float32)
            d = np.asarray(f["objects" if "objects" in keys else "object_ids"], np.int32)
            q = np.asarray(f["views" if "views" in keys else "view_ids"], np.int32)
        except KeyError as e:
            raise err(
                f"observation npz {path!r} lacks {e}; want images + "
                "objects/views (or object_ids/view_ids)"
            )
    if tuple(imgs.shape[1:]) != tuple(image_shape):
        raise err(
            f"observed images are {tuple(imgs.shape[1:])} but the model "
            f"serves {tuple(image_shape)}"
        )
    if not (imgs.shape[0] == d.shape[0] == q.shape[0]):
        raise err("observation npz arrays disagree on n")
    if ((d < 0) | (d >= P) | (q < 0) | (q >= Q)).any():
        raise err(
            f"observed cells outside the {P}×{Q} grid — conditioning can "
            "only absorb observations of known objects/views (new ones "
            "need a training run)"
        )
    return imgs, d, q


def _parse_requests(s: str, P: int, Q: int, err=ValueError) -> list[tuple[int, int]]:
    """Parse and grid-check a 'd:q,d:q,…' request string; `err` as in
    _load_observation_npz."""
    pairs = []
    for tok in s.split(","):
        parts = tok.split(":")
        try:
            if len(parts) != 2:
                raise ValueError(tok)
            d0, q0 = int(parts[0]), int(parts[1])
        except ValueError:
            raise err(
                f"bad request {tok.strip()!r}: want object:view, e.g. 3:2"
            ) from None
        if not (0 <= d0 < P and 0 <= q0 < Q):
            raise err(f"request {d0}:{q0} outside the {P}×{Q} grid")
        pairs.append((d0, q0))
    return pairs


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def _serve_stdin_loop(model, state: ServerState, x_map, extra: tuple, args,
                      lines=None, meta: dict | None = None) -> None:
    """Persistent online serving loop (serve --stdin): one command per input
    line, one JSON reply line each, EOF ends:

        d:q,d:q,…         answer a request batch (writes a .npz per batch)
        observe <npz>     fold new observed images into the posterior
        save <path>       persist the current server state + .meta.json

    Request and observation lines longer than --max_batch run in chunks of
    that size; the replies are the JAX loop's. `lines` overrides sys.stdin
    for tests."""
    B = int(args.max_batch)
    if B < 1:
        raise SystemExit("serve: --max_batch must be >= 1")
    P, Q = int(state.X.shape[0]), int(state.W.shape[0])
    device = state.core.M.device
    os.makedirs(args.outdir, exist_ok=True)
    print(json.dumps({"ready": True, "grid": [P, Q], "max_batch": B,
                      "commands": ["d:q,…", "observe <npz>", "save <path>"]}), flush=True)

    def _observe_line(k: int, path: str) -> None:
        nonlocal state
        imgs, dd, qq = _load_observation_npz(path, P, Q, model.image_shape)
        n = imgs.shape[0]
        t0 = time.perf_counter()
        for s0 in range(0, n, B):
            rows = slice(s0, min(s0 + B, n))
            state = observe(model, state, torch.from_numpy(imgs[rows]).to(device),
                            _index(dd[rows], device), _index(qq[rows], device),
                            x_map=x_map, extra_effects=extra)
        _sync(state.core.M)
        print(json.dumps({
            "line": k, "observed": int(n),
            "fold_s": round(time.perf_counter() - t0, 5),
        }), flush=True)

    for k, line in enumerate(lines if lines is not None else sys.stdin):
        line = line.strip()
        if not line:
            continue
        if line.startswith("observe ") or line.startswith("save "):
            try:
                if line.startswith("observe "):
                    _observe_line(k, line[len("observe "):].strip())
                else:
                    path = line[len("save "):].strip()
                    _resave(path, state, meta or {})
                    print(json.dumps({"line": k, "saved": path}), flush=True)
            except (ValueError, OSError, zipfile.BadZipFile) as e:
                print(json.dumps({"line": k, "error": str(e)}), flush=True)
            continue
        try:
            pairs = _parse_requests(line, P, Q)
        except ValueError as e:
            print(json.dumps({"line": k, "error": str(e)}), flush=True)
            continue
        t0 = time.perf_counter()
        d_all = np.fromiter((r[0] for r in pairs), np.int32)
        q_all = np.fromiter((r[1] for r in pairs), np.int32)
        imgs, var = [], []
        for s0 in range(0, len(pairs), B):
            rows = slice(s0, min(s0 + B, len(pairs)))
            y, v = predict_images(model, state, _index(d_all[rows], device),
                                  _index(q_all[rows], device), x_map=x_map,
                                  extra_effects=extra, return_var=True)
            imgs.append(y.cpu().numpy())
            var.append(v.cpu().numpy())
        y = np.concatenate(imgs, axis=0)
        var = np.concatenate(var, axis=0)
        npz = os.path.join(args.outdir, f"served_{k:04d}.npz")
        np.savez_compressed(npz, images=y, objects=d_all, views=q_all, posterior_var=var)
        print(json.dumps({
            "line": k, "n_requests": len(pairs),
            "latency_s": round(time.perf_counter() - t0, 5),
            "posterior_var": [round(float(v0), 6) for v0 in var],
            "npz": npz,
        }), flush=True)


def _repeat_throughput(call, d: torch.Tensor, q: torch.Tensor, P: int, Q: int,
                       repeat: int) -> dict:
    """End-to-end rate: the request batch re-served `repeat` times, indices
    rotated per rep (other grid cells each time), each rep ending in a full
    image readback to the host. The rotated index vectors are built on the
    device before the timed window."""
    call(d, q).cpu()  # warm outside the timing
    reqs = [((d + i + 1) % P, (q + i + 1) % Q) for i in range(repeat)]
    _sync(d)
    reps = []
    for dd, qq in reqs:
        t0 = time.perf_counter()
        call(dd, qq).cpu()
        reps.append(time.perf_counter() - t0)
    return {
        "repeat": repeat,
        "repeat_latency_s_min": round(min(reps), 5),
        "repeat_latency_s_median": round(sorted(reps)[len(reps) // 2], 5),
        "images_per_sec": round(len(d) / min(reps)),
    }


def _sustained_throughput(call, d: torch.Tensor, q: torch.Tensor, P: int, Q: int,
                          k: int) -> dict:
    """Decode capacity (bench.py's oos_serving protocol): k rotated request
    batches enqueued back to back with no host sync inside the chain, each
    reduced to a per-image checksum that depends on every pixel, and one
    readback of the (k, n) checksums at the end; best of three chains. The
    counterpart of the JAX package's single-dispatch lax.scan."""
    def burst(d0):
        sums = []
        for i in range(k):
            y = call((d0 + i) % P, (q + i) % Q)
            sums.append(torch.sum(y, dim=tuple(range(1, y.ndim))))
        return torch.stack(sums)

    burst(d).cpu()  # warm outside the timing
    reqs = [(d + 7 * i + 1) % P for i in range(3)]
    _sync(d)
    reps = []
    for dd in reqs:
        t0 = time.perf_counter()
        burst(dd).cpu()
        reps.append(time.perf_counter() - t0)
    return {
        "sustained_chain": k,
        "sustained_latency_s_min": round(min(reps), 5),
        "sustained_images_per_sec": round(k * len(d) / min(reps)),
    }


def _model_from_meta(meta: dict, vae_params: dict, device) -> VAE:
    """The VAE an artifact was exported with: architecture, decoder and the
    compute dtype the run trained with (bfloat16 for a bfloat16 run, float32
    polish tail or not, as the JAX serve builds it), holding vae_params."""
    model = VAE(int(meta["zdim"]), tuple(meta["image_shape"]),
                tuple(meta.get("enc_features", (32, 64, 128))),
                tuple(meta.get("dec_features", (128, 64, 32))),
                meta.get("dec_upsample", "resize"),
                dtype=compute_dtype(meta.get("compute_dtype", "float32")))
    model.load_state_dict(vae_params)
    return model.to(device)


def main(argv=None):
    """Serve conditional generations from an exported artifact:

        python -m gppvae_tpu_torch serve --state model.srv \\
            --requests 3:2,5:0,12:7 [--sample K [--joint]] [--var] [--outdir DIR]

    Loads the N-independent server state written by `generate
    --export_server` (architecture and feature-map config from the
    .meta.json sidecar), answers the requested (object:view) cells
    (predictive means by default, K posterior draws per cell with --sample)
    and writes a PNG panel + .npz beside a JSON stats line. --device
    defaults to cuda and raises without it; --device cpu runs on the CPU.
    """
    import argparse

    p = argparse.ArgumentParser(description="GPPVAE serving CLI")
    p.add_argument("--state", default=None,
                   help="server-state artifact from generate --export_server")
    p.add_argument("--exe", default=None,
                   help="compiled-program artifact (not ported yet; see ROADMAP)")
    p.add_argument("--export_exe", default=None, metavar="PATH",
                   help="serialize the serving surface (not ported yet; see ROADMAP)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--requests", default=None,
                   help="comma-separated object:view pairs, e.g. 3:2,5:0")
    p.add_argument("--stdin", action="store_true",
                   help="persistent online serving loop: one command per stdin "
                        "line — 'd:q,d:q,…' answers a request batch (JSON line "
                        "+ .npz under --outdir), 'observe <npz>' folds new "
                        "observed images into the posterior, 'save <path>' "
                        "persists the updated state; EOF exits")
    p.add_argument("--max_batch", type=int, default=64,
                   help="--stdin mode: longer lines run in chunks of this size")
    p.add_argument("--sample", type=int, default=0,
                   help="decode K posterior draws per cell instead of the mean")
    p.add_argument("--joint", action="store_true",
                   help="with --sample: draw the K samples jointly over the whole "
                        "request batch from the full n×n posterior covariance")
    p.add_argument("--var", action="store_true",
                   help="also report the GP-predictive latent variance per cell")
    p.add_argument("--repeat", type=int, default=0,
                   help="throughput mode: re-serve the request batch K more times "
                        "(indices rotated per rep), full image readback each, and "
                        "report images_per_sec over the best rep")
    p.add_argument("--sustained", type=int, default=0, metavar="K",
                   help="decode-capacity mode: K rotated request batches back to "
                        "back with no host sync, checksum readback only; reports "
                        "sustained_images_per_sec")
    p.add_argument("--seed", type=int, default=0, help="--sample RNG seed")
    p.add_argument("--observe", default=None, metavar="NPZ",
                   help="fold new observed images into the posterior before "
                        "answering (streaming conditioning): an .npz with images "
                        "(n,H,W,C in [0,1]), objects (n,) and views (n,) — the "
                        "layout serve itself writes; object_ids/view_ids also "
                        "work. Requires --save_state")
    p.add_argument("--save_state", default=None, metavar="PATH",
                   help="--observe: write the updated server state (+ its "
                        ".meta.json sidecar) here")
    p.add_argument("--outdir", default=".")
    args = p.parse_args(argv)

    if args.exe or args.export_exe:
        raise NotImplementedError(
            "serve --exe / --export_exe (the compiled-program artifact) is not "
            "ported to gppvae_tpu_torch yet (see ROADMAP); the JAX package "
            "gppvae_tpu has it"
        )
    if args.state is None:
        raise SystemExit("serve: pass exactly one of --state or --exe")
    device = resolve_device(args.device)
    set_float32_precision("float32")
    state, meta = load_server_state(args.state, map_location=device)
    if "image_shape" not in meta:
        raise ValueError(
            f"{args.state}.meta.json lacks image_shape — re-export with "
            "generate --export_server"
        )
    model = _model_from_meta(meta, state.vae_params, device)
    x_map = x_map_from_meta(meta, state.X.shape[1])
    extra = tuple(meta.get("extra_effects", ()))
    P, Q = int(state.X.shape[0]), int(state.W.shape[0])

    if args.observe:
        if args.save_state is None:
            raise SystemExit("serve: --observe needs --save_state for the "
                             "updated artifact")
        if args.stdin or args.sample:
            raise SystemExit("serve: --observe folds then optionally answers "
                             "--requests; --stdin/--sample are separate runs")
        imgs, d_new, q_new = _load_observation_npz(
            args.observe, P, Q, meta["image_shape"], err=SystemExit)
        t0 = time.perf_counter()
        state = observe(model, state, torch.from_numpy(imgs).to(device),
                        _index(d_new, device), _index(q_new, device),
                        x_map=x_map, extra_effects=extra)
        _sync(state.core.M)
        fold_s = round(time.perf_counter() - t0, 4)
        _resave(args.save_state, state, meta)
        print(json.dumps({
            "observed": int(imgs.shape[0]), "fold_s": fold_s,
            "save_state": args.save_state,
        }), flush=True)
        if args.requests is None:
            return

    if args.stdin == (args.requests is not None) and not args.observe:
        raise SystemExit("serve: pass exactly one of --requests or --stdin")
    if args.stdin and (args.sample or args.repeat or args.sustained):
        raise SystemExit(
            "serve: --sample/--repeat/--sustained are not supported with "
            "--stdin"
        )
    if (args.repeat or args.sustained) and args.sample:
        raise SystemExit(
            "serve: --repeat/--sustained (throughput modes) measure the"
            " posterior-mean path; drop --sample or the throughput flag"
        )
    if args.stdin:
        _serve_stdin_loop(model, state, x_map, extra, args, meta=meta)
        return

    pairs = _parse_requests(args.requests, P, Q, err=SystemExit)
    d = _index([r[0] for r in pairs], device)
    q = _index([r[1] for r in pairs], device)

    if args.joint and not args.sample:
        raise SystemExit("serve: --joint modifies --sample; pass --sample K")
    if args.sample and args.var:
        raise SystemExit(
            "serve: --sample decodes posterior draws; --var reports the "
            "diagonal of the same posterior — pass one of them"
        )
    t0 = time.perf_counter()
    out = {"n_requests": len(pairs), "state": args.state}
    if args.sample:
        y = sample_images(model, state, d, q, torch.Generator().manual_seed(args.seed),
                          args.sample, x_map=x_map, extra_effects=extra,
                          joint=args.joint).cpu().numpy()
        rows = [y[i] for i in range(len(pairs))]  # one panel row per cell
        out["samples_per_request"] = args.sample
        if args.joint:
            out["joint"] = True
    else:
        res = predict_images(model, state, d, q, x_map=x_map, extra_effects=extra,
                             return_var=args.var)
        y, var = res if args.var else (res, None)
        rows = [y.cpu().numpy()]
        if var is not None:
            out["posterior_var"] = [round(float(v), 6) for v in var.cpu()]
    out["latency_s"] = round(time.perf_counter() - t0, 4)

    def call(dd, qq):
        return predict_images(model, state, dd, qq, x_map=x_map, extra_effects=extra)

    if args.repeat > 0:
        out.update(_repeat_throughput(call, d, q, P, Q, args.repeat))
    if args.sustained > 0:
        out.update(_sustained_throughput(call, d, q, P, Q, args.sustained))

    os.makedirs(args.outdir, exist_ok=True)
    panel = os.path.join(args.outdir, "served.png")
    save_panel(panel, rows)
    npz = os.path.join(args.outdir, "served.npz")
    np.savez_compressed(npz, images=rows[0] if not args.sample else y,
                        objects=np.asarray([r[0] for r in pairs], np.int32),
                        views=np.asarray([r[1] for r in pairs], np.int32))
    out["panel"] = panel
    out["npz"] = npz
    print(json.dumps(out))
