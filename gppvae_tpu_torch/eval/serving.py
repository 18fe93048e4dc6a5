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
`model` to `state.vae_params`. Random draws are the JAX package's from an
explicit key (utils/prng.py: `serve --sample K --seed s` draws
normal(PRNGKey(s), (n, K, L)) on the host, as serving.py:209-219 does), or
are injected (`eps`). The device is the state's: nothing here moves a
tensor to the CPU except where a reply is written.

The artifact (`save_server_state`) also carries the object kernel's RFF
draws Ω, b, which the JAX package rebuilds from the training seed
(serving.py:617-624; gp.rff_draws gives the same), so that the artifact
alone fixes the kernel.

The compiled-program surface (`serve --state m.srv --export_exe m.exe`,
then `serve --exe m.exe`) goes through torch.export: one program per entry
of _EXE_ENTRIES, the state's tensors baked in as buffers, the batch and the
sample count symbolic, answered at serve time by the loaded graph alone
(no VAE, no feature map, no gp function). The sample entries take ε where
the JAX entries take a seed, and `serve --exe` draws it on the host from
PRNGKey(--seed), so that --exe and --state answer a seed alike;
an exported graph records the device of its constants, so an artifact is
exported once per device named in `platforms` and refused by name on any
other.

Data parallelism (`group=`, a parallel.DataGroup per rank, as the JAX
functions take `batch_sharding=`): the fold and observe take the rank's rows
(any split) and all-reduce only the R-sized sums (gp.factorize,
gp.posterior_core, gp.extend_posterior_core), so every rank holds the same
state; predict_images takes the whole request on every rank, computes the
rank's block of its rows against that state and assembles the reply with one
all-reduce of the zero-filled blocks.
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
from gppvae_tpu_torch.models import VAE, vae_from_record
from gppvae_tpu_torch.parallel import all_reduce, row_block
from gppvae_tpu_torch.train.device import resolve_device, set_float32_precision
from gppvae_tpu_torch.utils import prng
from gppvae_tpu_torch.utils.timers import span


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


def _encode_all(model, vae_params: dict, images: torch.Tensor, chunk: int | None) -> torch.Tensor:
    """Latent means of every row, `chunk` rows at a time, with the encoder
    run on `vae_params` (models.encode_all on the state's weights). None:
    one forward and no Python loop over the row count, which is what a
    symbolic batch (torch.export) needs."""
    enc = _part(vae_params, "encoder")
    if chunk is None:
        return functional_call(model.encoder, enc, (images,))[0]
    chunk = max(1, min(chunk, images.shape[0]))  # a rank may hold no rows
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
                       extra_effects: tuple = (), encode_chunk: int = 1024,
                       group=None) -> ServerState:
    """Fold the training set into the R-sized posterior core: the
    grad-free full encode, the factorization of K = Σ_r v_r V_r V_rᵀ + v_n I
    and the K⁻¹Z core, once. params: {'vae': state_dict, 'gp': {'X', ['W'],
    'log_vs', 'log_vn', ...}}; fixed_W is the 'dis'-mode view matrix. With a
    group, images_tr, d_tr, q_tr are the rank's rows and the state is every
    rank's alike."""
    W = params["gp"]["W"] if "W" in params["gp"] else fixed_W
    X = params["gp"]["X"]
    with span("fold"):
        with span("fold.encode"):
            Z0 = _encode_all(model, params["vae"], images_tr, encode_chunk)
        with span("fold.factorize"):
            V_tr = gp.build_effect_rows(X, W, d_tr, q_tr, extra_effects=extra_effects,
                                        x_map=x_map)
            v_sig, v_noise = gp.variances_from_log(params["gp"]["log_vs"],
                                                   params["gp"]["log_vn"])
            v_sig = v_sig.reshape(-1)
            factors = gp.factorize(V_tr, [v_sig[i] for i in range(len(V_tr))], v_noise,
                                   group=group)
        with span("fold.core"):
            # the encoder returns float32 latents whatever the GP's dtype
            core = gp.posterior_core(factors, Z0.to(factors.U.dtype), group=group)
    return ServerState(core=core, X=X, W=W,
                       v_sig=v_sig,
                       vae_params=params["vae"])


@torch.no_grad()
def decode_images(model, vae_params: dict, z: torch.Tensor, chunk: int | None = 512) -> torch.Tensor:
    """sigmoid(decode(z)) in chunks of at most `chunk` rows, which bounds
    the activations of a large joint sample; the chunks give the rows a
    single forward gives. None: one forward and no Python loop over the row
    count (a symbolic batch under torch.export). Latents and images are
    float32 whatever the model's compute dtype."""
    dec = _part(vae_params, "decoder")
    if chunk is None or z.shape[0] <= chunk:
        return torch.sigmoid(functional_call(model.decoder, dec, (z,)))
    return torch.cat([torch.sigmoid(functional_call(model.decoder, dec, (z[s:s + chunk],)))
                      for s in range(0, z.shape[0], chunk)])


@torch.no_grad()
def predict_images(model, state: ServerState, d: torch.Tensor, q: torch.Tensor, *,
                   x_map=None, extra_effects: tuple = (), return_var: bool = False,
                   group=None):
    """Serve one request batch: images (n, H, W, C) for the (object, view)
    index vectors, O(R) GP work per row and one decoder forward; with
    return_var=True also the (n,) GP-predictive latent variance. With a
    group (the state alike on every rank), each rank computes its block of
    the rows and every rank returns the whole reply."""
    with span("serve.predict"):
        n = d.shape[0]
        if group is not None:
            block = row_block(n, group)
            d, q = d[block], q[block]
        with span("serve.gp"):
            V_star, v_sigs = _effect_rows(state, d, q, x_map=x_map,
                                          extra_effects=extra_effects)
            out = gp.predict_from_core(V_star, state.core, v_sigs, return_var=return_var)
            z_star, var = out if return_var else (out, None)
        with span("serve.decode"):
            y = decode_images(model, state.vae_params, z_star, chunk=None)
        if group is not None:
            y = _assemble(group, y, n, block)
            var = None if var is None else _assemble(group, var, n, block)
    return (y, var) if return_var else y


def _assemble(group, part: torch.Tensor, n: int, block: slice) -> torch.Tensor:
    """The n rows whose block `part` is on this rank, from every rank's
    block: one all-reduce of the blocks placed in zeros (x + 0 is exact)."""
    whole = torch.zeros((n, *part.shape[1:]), dtype=part.dtype, device=part.device)
    whole[block] = part
    return all_reduce(group, whole)


def stable_cholesky(cov: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """Cholesky of (C + Cᵀ)/2 plus a scale-relative jitter: jitter ×
    max(1, mean(diag)) on the diagonal, since the roundoff of U*B⁻¹U*ᵀ grows
    with the core's scale and an absolute jitter can sit below it when
    request rows repeat."""
    cov = 0.5 * (cov + cov.T)
    scale = torch.clamp(torch.mean(torch.diagonal(cov)), min=1.0)
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky(cov + (jitter * scale) * eye)


def _normal(key, shape, like: torch.Tensor, eps=None) -> torch.Tensor:
    """Standard normal draws of `shape` from the prng `key` (drawn on the
    host), or the injected `eps`, on like's device and dtype."""
    if eps is None:
        eps = torch.from_numpy(prng.normal(key, shape))
    elif not torch.is_tensor(eps):
        eps = torch.tensor(np.asarray(eps))
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"eps of shape {tuple(eps.shape)}; want {tuple(shape)}")
    return eps.to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def sample_images(model, state: ServerState, d: torch.Tensor, q: torch.Tensor,
                  key, num_samples: int, *, x_map=None,
                  extra_effects: tuple = (), joint: bool = False, jitter: float = 1e-6,
                  decode_chunk: int | None = 512, eps=None) -> torch.Tensor:
    """K decoded posterior draws per requested row, (n, K, H, W, C).

    Independent: z ~ N(μ*, σ*² I_L) per row from the diagonal variance.
    joint=True: coherent draws over the whole request batch from the full
    n×n posterior covariance (gp.predict_cov_from_core), z[:, k, l] =
    μ[:, l] + L_c ε[:, k, l], so rows of one object vary together.
    ε is normal(key, (n, K, L)), the JAX function's draw from the same key;
    eps (n, K, L) replaces it (key None)."""
    V_star, v_sigs = _effect_rows(state, d, q, x_map=x_map, extra_effects=extra_effects)
    if joint:
        mean, cov = gp.predict_cov_from_core(V_star, state.core, v_sigs)
        n, L = mean.shape
        e = _normal(key, (n, num_samples, L), mean, eps)
        z = mean[:, None, :] + torch.einsum("ij,jkl->ikl", stable_cholesky(cov, jitter), e)
    else:
        mean, var = gp.predict_from_core(V_star, state.core, v_sigs, return_var=True)
        n, L = mean.shape
        e = _normal(key, (n, num_samples, L), mean, eps)
        z = mean[:, None, :] + torch.sqrt(torch.clamp(var, min=0.0))[:, None, None] * e
    y = decode_images(model, state.vae_params, z.reshape(n * num_samples, L), decode_chunk)
    return y.reshape(n, num_samples, *y.shape[1:])


@torch.no_grad()
def observe(model, state: ServerState, images: torch.Tensor, d: torch.Tensor,
            q: torch.Tensor, *, x_map=None, extra_effects: tuple = (),
            encode_chunk: int | None = 1024,
            row_mask: torch.Tensor | None = None, group=None) -> ServerState:
    """Fold new observed images into the serving posterior (streaming
    conditioning): encode them, build their feature rows from the state's
    X, W and extend the core (gp.extend_posterior_core), O(n·R² + R³). The
    same state build_server_state gives with these rows in the training
    set; the GP and VAE parameters stay fixed. row_mask (n,) ∈ {0, 1}:
    weight-0 rows contribute nothing (their feature rows are zeroed).
    encode_chunk=None encodes in one forward. With a group, the new rows
    are the rank's and the extended state is every rank's alike."""
    V_new, v_sigs = _effect_rows(state, d, q, x_map=x_map, extra_effects=extra_effects)
    if row_mask is not None:
        m = row_mask.to(V_new[0].dtype)[:, None]
        V_new = [v * m for v in V_new]
    Z_new = _encode_all(model, state.vae_params, images, encode_chunk)
    return state._replace(core=gp.extend_posterior_core(state.core, V_new, v_sigs, Z_new,
                                                        group=group))


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


# exported-program entry points: the names and file suffixes of
# gppvae_tpu/eval/serving.py:360-390. Two differences from the JAX entries,
# both in the `sig` strings: the indices are int64, and the sample entries
# take eps f32[b,k,L] where the JAX entries take `seed` and `k_dummy` (the
# caller draws it from PRNGKey(seed); k is eps's second dimension).
# The core is passed and returned as its four tensors.
_CORE_SIG = "M:f32[R,L], G:f32[R,R], Lb:f32[R,R], v_noise:f32[]"
_EXE_ENTRIES = {
    "mean": {"suffix": "", "sig": "call(d:i64[b], q:i64[b]) -> y:f32[b,H,W,C]"},
    "var": {"suffix": ".var", "sig": "call(d, q) -> (y:f32[b,H,W,C], var:f32[b])"},
    "sample": {"suffix": ".sample",
               "sig": "call(d, q, eps:f32[b,k,L]) -> y:f32[b,k,H,W,C]  (independent "
                      "per-row draws; eps ~ N(0, I) is drawn by the caller)"},
    "sample_joint": {"suffix": ".joint",
                     "sig": "call(d, q, eps:f32[b,k,L]) -> y:f32[b,k,H,W,C]  (one coherent "
                            "scene per draw via the full b×b posterior covariance)"},
    "observe": {"suffix": ".observe",
                "sig": f"call({_CORE_SIG}, images:f32[b,H,W,C], d, q, mask:f32[b]) -> "
                       "(M', G', Lb', v_noise)  (streaming conditioning; mask 0-rows "
                       "are ignored)"},
    "sample_core": {"suffix": ".sample_core",
                    "sig": f"call({_CORE_SIG}, d, q, eps:f32[b,k,L]) -> y:f32[b,k,H,W,C]  "
                           "(independent per-row draws from an observe-updated core)"},
    "sample_joint_core": {"suffix": ".joint_core",
                          "sig": f"call({_CORE_SIG}, d, q, eps:f32[b,k,L]) -> "
                                 "y:f32[b,k,H,W,C]  (coherent scenes from the updated "
                                 "core's full b×b posterior covariance)"},
    "predict_core": {"suffix": ".predict",
                     "sig": f"call({_CORE_SIG}, d, q) -> (y:f32[b,H,W,C], var:f32[b])  "
                            "(serve from an observe-updated core; initial core in "
                            "<path>.core.npz)"},
}
_STATEFUL_ENTRIES = ("observe", "predict_core", "sample_core", "sample_joint_core")
EXE_FORMAT = "torch.export.v1"


class _EntryProgram(torch.nn.Module):
    """One entry of _EXE_ENTRIES as a module to export: the state's tensors
    are its buffers (baked into the artifact) and `forward` is the library
    function of that entry. Only the half of the VAE the entry runs is held
    (the encoder for `observe`, the decoder elsewhere), and a stateful entry
    holds no core: it takes one. Each buffer is a contiguous copy: the
    archive writer stores whole storages, and L_B comes column-major out of
    the Cholesky. `model` gives the architecture and the compute dtype and
    runs on the buffers (functional_call); it is kept out of the module
    tree, so its own parameters are not saved as well."""

    def __init__(self, name: str, model, state: ServerState, x_map, extra_effects: tuple):
        super().__init__()
        self.name, self.x_map, self.extra_effects = name, x_map, tuple(extra_effects)
        object.__setattr__(self, "model", model)

        def own(t: torch.Tensor) -> torch.Tensor:
            return t.detach().clone(memory_format=torch.contiguous_format)

        half = "encoder." if name == "observe" else "decoder."
        self.vae_keys = [k for k in state.vae_params if k.startswith(half)]
        for i, k in enumerate(self.vae_keys):
            self.register_buffer(f"vae_{i}", own(state.vae_params[k]))
        for f in ("X", "W", "v_sig"):
            self.register_buffer(f, own(getattr(state, f)))
        if name not in _STATEFUL_ENTRIES:
            for f, v in state.core._asdict().items():
                self.register_buffer(f"core_{f}", own(v))

    def _state(self, core=None) -> ServerState:
        if core is None:
            core = [getattr(self, f"core_{f}") for f in gp.PosteriorCore._fields]
        return ServerState(core=gp.PosteriorCore(*core), X=self.X, W=self.W, v_sig=self.v_sig,
                           vae_params={k: getattr(self, f"vae_{i}")
                                       for i, k in enumerate(self.vae_keys)})

    def forward(self, *args):
        kw = dict(x_map=self.x_map, extra_effects=self.extra_effects)
        name = self.name
        core, args = (args[:4], args[4:]) if name in _STATEFUL_ENTRIES else (None, args)
        state = self._state(core)
        if name == "observe":
            images, d, q, mask = args
            return tuple(observe(self.model, state, images, d, q, encode_chunk=None,
                                 row_mask=mask, **kw).core)
        if name in ("mean", "var", "predict_core"):
            return predict_images(self.model, state, *args, return_var=name != "mean", **kw)
        d, q, eps = args
        return sample_images(self.model, state, d, q, None, eps.shape[1], eps=eps,
                             joint="joint" in name, decode_chunk=None, **kw)


def _entry_example(name: str, state: ServerState, image_shape, device):
    """(example arguments, dynamic_shapes) of one entry: b and k symbolic
    from 1 up, the core's sizes fixed."""
    from torch.export import Dim

    b, k = Dim("b", min=1), Dim("k", min=1)
    n, K, L = 3, 2, state.core.M.shape[1]  # sizes other than 0 and 1, which export specializes
    idx = torch.zeros(n, dtype=torch.int64, device=device)
    args, shapes = [idx, idx.clone()], [{0: b}, {0: b}]
    if name == "observe":
        args = [torch.zeros((n, *image_shape), device=device), *args,
                torch.ones(n, device=device)]
        shapes = [{0: b}, *shapes, {0: b}]
    elif name.startswith("sample"):
        args.append(torch.zeros((n, K, L), device=device))
        shapes.append({0: b, 1: k})
    if name in _STATEFUL_ENTRIES:
        args, shapes = [*state.core, *args], [None] * 4 + shapes
    return tuple(args), tuple(shapes)


def _state_to(state: ServerState, device) -> ServerState:
    def move(t):
        return t.to(device)

    return ServerState(core=gp.PosteriorCore(*map(move, state.core)), X=move(state.X),
                       W=move(state.W), v_sig=move(state.v_sig),
                       vae_params={k: move(v) for k, v in state.vae_params.items()})


def _save_core_npz(path: str, core: gp.PosteriorCore) -> None:
    np.savez(path, **{f: v.detach().cpu().numpy() for f, v in core._asdict().items()})


def _load_core_npz(path: str, device) -> gp.PosteriorCore:
    with np.load(path) as f:
        return gp.PosteriorCore(**{k: torch.from_numpy(f[k]).to(device) for k in f.files})


def _load_user_core(path: str, exe: str, device) -> gp.PosteriorCore:
    """The --core NPZ of an --exe run, held to the artifact's own initial
    core: the same four tensors at the same shapes (R and zdim are fixed in
    the exported graphs), else SystemExit naming the file."""
    like, _ = load_compiled_program(exe, "core", device)
    want = {k: tuple(v.shape) for k, v in like._asdict().items()}
    try:
        with np.load(path) as f:
            got = {k: tuple(f[k].shape) for k in f.files}
    except (OSError, ValueError) as e:
        raise SystemExit(f"serve: --core {path!r} is not a readable npz: {e}")
    if got != want:
        raise SystemExit(f"serve: --core {path!r} holds {got}; {exe!r} serves from a "
                         f"posterior core of {want} (write one with --observe --save_core)")
    return _load_core_npz(path, device)


def export_compiled_program(model, state: ServerState, path: str, *, x_map=None,
                            extra_effects: tuple = (), platforms: tuple | None = None,
                            entry_points: tuple = tuple(_EXE_ENTRIES)) -> dict:
    """Serialize the whole serving surface with torch.export: the server
    state (posterior core and the VAE half an entry runs) baked in as
    buffers, the batch and the sample count symbolic from 1 up.

    The `.srv` artifact needs this package at serve time to rebuild the VAE
    and the feature map; an exported program is a graph of ATen ops that
    `torch.export.load(file).module()` answers requests with. Entries (see
    _EXE_ENTRIES): means, means + variance, K draws (independent and joint;
    the caller passes ε, whose second size is K) and the stateful
    `observe` / `predict_core` / `sample_core` / `sample_joint_core`, which
    take the R-sized posterior core as four tensors, so that a deployment
    can stream observations and serve the sharpened posterior. The initial
    core rides in `<path>.core.npz`.

    platforms: torch device types ('cuda', 'cpu') to export for, default
    the state's own. An exported graph records the device of its constants
    and factory calls, so each platform gets its own programs: the first
    at `<path><suffix>`, any further one at `<path><suffix>@<platform>`.
    Writes `<path>.meta.json` (grid, image shape, zdim, the entry table
    with file, sig, bytes and export seconds, platforms, torch version,
    compute dtype) and returns it."""
    unknown = set(entry_points) - set(_EXE_ENTRIES)
    if unknown:
        raise ValueError(f"unknown export entry points: {sorted(unknown)}")
    platforms = tuple(platforms or (state.core.M.device.type,))
    apath = os.path.abspath(os.path.expanduser(path))
    entries: dict = {}
    total = 0
    for i, platform in enumerate(platforms):
        device = resolve_device(platform)
        st = _state_to(state, device)
        for name in entry_points:
            t0 = time.perf_counter()
            args, shapes = _entry_example(name, st, model.image_shape, device)
            entry = _EntryProgram(name, model, st, x_map, extra_effects)
            with torch.no_grad():
                program = torch.export.export(entry, args, dynamic_shapes={"args": shapes},
                                              strict=False)
            fname = apath + _EXE_ENTRIES[name]["suffix"] + (f"@{platform}" if i else "")
            with open(fname, "wb") as f:  # an open file: save() wants a name to end in .pt2
                torch.export.save(program, f)
            total += os.path.getsize(fname)
            e = entries.setdefault(name, {
                "file": os.path.basename(fname), "sig": _EXE_ENTRIES[name]["sig"],
                "bytes": os.path.getsize(fname), "files": {}})
            e["files"][platform] = os.path.basename(fname)
            e["export_s"] = round(e.get("export_s", 0.0) + time.perf_counter() - t0, 3)
    core_npz = None
    if any(e in entries for e in _STATEFUL_ENTRIES):
        core_npz = apath + ".core.npz"
        _save_core_npz(core_npz, state.core)
    meta = {
        "format": EXE_FORMAT,
        "grid": [int(state.X.shape[0]), int(state.W.shape[0])],
        "image_shape": [int(s) for s in model.image_shape],
        "zdim": int(state.core.M.shape[1]),
        "platforms": list(platforms),
        "entry_points": entries,
        "core_npz": os.path.basename(core_npz) if core_npz else None,
        "bytes": entries.get("mean", {}).get("bytes"),
        "total_bytes": total,
        "torch": torch.__version__,
        "compute_dtype": str(model.dtype).removeprefix("torch."),
    }
    with open(apath + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_compiled_program(path: str, entry: str = "mean", device=None):
    """(program, meta) of an `export_compiled_program` artifact: `program`
    is the loaded graph as a module, called as
    meta["entry_points"][entry]["sig"] says, with tensors on `device`
    (default: the first platform the artifact was exported for). A device
    the artifact was not exported for is refused by name. entry="core"
    returns (PosteriorCore, meta) from the `<path>.core.npz` initial-state
    sidecar of the stateful entries."""
    apath = os.path.abspath(os.path.expanduser(path))
    meta_path = apath + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"compiled-program sidecar {meta_path} not found: it records "
            "the grid bounds used to validate requests."
        )
    with open(meta_path) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt != EXE_FORMAT:
        raise ValueError(
            f"{path!r} records format {fmt!r}; this build reads {EXE_FORMAT} "
            "(a jax.export artifact is served by the JAX package; re-export "
            "with serve --state … --export_exe)"
        )
    platform = torch.device(device).type if device is not None else meta["platforms"][0]
    if platform not in meta["platforms"]:
        raise ValueError(
            f"{path!r} was exported for {meta['platforms']}, not for {platform!r}: an "
            "exported program records its device; re-export with --exe_platforms "
            f"{platform} or serve with --device {meta['platforms'][0]}"
        )
    if entry == "core":
        if not meta.get("core_npz"):
            raise ValueError(
                f"{path!r} was exported without the stateful entries — "
                "no core sidecar"
            )
        return _load_core_npz(os.path.join(os.path.dirname(apath), meta["core_npz"]),
                              device if device is not None else platform), meta
    if entry not in meta.get("entry_points", {}):
        raise ValueError(
            f"{path!r} exports {sorted(meta.get('entry_points', {}))}; "
            f"no entry {entry!r}"
        )
    fname = meta["entry_points"][entry]["files"][platform]
    with open(os.path.join(os.path.dirname(apath), fname), "rb") as f:
        program = torch.export.load(f).module()
    return program, meta


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


def _serve_stdin_loop(args, *, grid, image_shape, device, predict, observe, save,
                      ready: dict | None = None, lines=None) -> None:
    """Persistent online serving loop (serve --stdin), for either surface:
    one command per input line, one JSON reply line each, EOF ends:

        d:q,d:q,…         answer a request batch (writes a .npz per batch)
        observe <npz>     fold new observed images into the posterior
        save <path>       persist what `save` persists (the server state
                          under --state, the core npz under --exe)

    The surface is three callables on `device` tensors: predict(d, q) ->
    (y, var), observe(images, d, q), which updates the posterior it serves
    from, and save(path). Request and observation lines longer than
    --max_batch run in chunks of that size, each at its own size (a torch
    program does not recompile per batch size, so nothing is padded); the
    replies are the JAX loop's. `ready` adds keys to the first line; `lines`
    overrides sys.stdin for tests."""
    B = int(args.max_batch)
    if B < 1:
        raise SystemExit("serve: --max_batch must be >= 1")
    P, Q = grid
    os.makedirs(args.outdir, exist_ok=True)
    print(json.dumps({"ready": True, "grid": [P, Q], "max_batch": B, **(ready or {}),
                      "commands": ["d:q,…", "observe <npz>", "save <path>"]}), flush=True)

    def _observe_line(k: int, path: str) -> None:
        imgs, dd, qq = _load_observation_npz(path, P, Q, image_shape)
        n = imgs.shape[0]
        t0 = time.perf_counter()
        for s0 in range(0, n, B):
            rows = slice(s0, min(s0 + B, n))
            observe(torch.from_numpy(imgs[rows]).to(device), _index(dd[rows], device),
                    _index(qq[rows], device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
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
                    save(path)
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
            y, v = predict(_index(d_all[rows], device), _index(q_all[rows], device))
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


def _state_surface(model, state: ServerState, x_map, extra: tuple, meta: dict) -> dict:
    """The stdin loop's three callables over a server state (--state)."""
    kw = dict(x_map=x_map, extra_effects=extra)

    def predict(d, q):
        return predict_images(model, state, d, q, return_var=True, **kw)

    def observe_(images, d, q):
        nonlocal state
        state = observe(model, state, images, d, q, **kw)

    return dict(predict=predict, observe=observe_, save=lambda path: _resave(path, state, meta))


def _exe_surface(exe: str, core: gp.PosteriorCore, device) -> dict:
    """The stdin loop's three callables over the exported programs alone
    (--exe): `predict_core` on the current core, `observe` (loaded at the
    first observe line) with a mask of ones, and the core as a plain npz."""
    predict_core = load_compiled_program(exe, "predict_core", device)[0]
    observe_core = None

    def observe_(images, d, q):
        nonlocal core, observe_core
        if observe_core is None:
            observe_core = load_compiled_program(exe, "observe", device)[0]
        core = gp.PosteriorCore(*observe_core(*core, images, d, q,
                                              torch.ones(d.shape[0], device=device)))

    return dict(predict=lambda d, q: predict_core(*core, d, q), observe=observe_,
                save=lambda path: _save_core_npz(path, core))


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
    """The VAE an artifact was exported with (the architecture its meta
    records, read by vae_from_record), holding vae_params."""
    model = vae_from_record(meta, tuple(meta["image_shape"]))
    model.load_state_dict(vae_params)
    return model.to(device)


def _serve_exe(args) -> None:
    """Answer --requests straight from a compiled-program artifact
    (`--export_exe` output): load the entry the flags ask for, validate
    against the recorded grid, call. No model is rebuilt and no feature map:
    the loaded graph is the whole serving path. --var, --sample K [--joint]
    pick the uncertainty entries; --observe folds an npz into the core and
    --save_core keeps it; --core serves from such a core. ε of --sample is
    drawn here from PRNGKey(--seed) as sample_images draws it, so the draws
    are those of `serve --state` (and of the JAX package) with the same
    flags."""
    device = resolve_device(args.device)
    set_float32_precision("float32")
    core = None
    if args.core:
        # the (observe-updated) core is the only state, kept as a plain npz
        core = _load_user_core(args.core, args.exe, device)
    elif args.observe:
        core, _ = load_compiled_program(args.exe, "core", device)
    if args.observe:
        observe_core, meta0 = load_compiled_program(args.exe, "observe", device)
        P, Q = meta0["grid"]
        imgs, d_new, q_new = _load_observation_npz(
            args.observe, P, Q, meta0["image_shape"], err=SystemExit)
        t0 = time.perf_counter()
        core = gp.PosteriorCore(*observe_core(
            *core, torch.from_numpy(imgs).to(device), _index(d_new, device),
            _index(q_new, device), torch.ones(imgs.shape[0], device=device)))
        _sync(core.M)
        fold_s = round(time.perf_counter() - t0, 4)
        _save_core_npz(args.save_core, core)
        print(json.dumps({"observed": int(imgs.shape[0]), "fold_s": fold_s,
                          "save_core": args.save_core}), flush=True)
        if args.requests is None:
            return

    entry = "mean"
    if args.sample:
        if core is not None:  # draws from the observe-updated posterior
            entry = "sample_joint_core" if args.joint else "sample_core"
        else:
            entry = "sample_joint" if args.joint else "sample"
    elif core is not None:
        entry = "predict_core"
    elif args.var:
        entry = "var"
    program, meta = load_compiled_program(args.exe, entry, device)
    P, Q = meta["grid"]
    pairs = _parse_requests(args.requests, P, Q, err=SystemExit)
    d = _index([r[0] for r in pairs], device)
    q = _index([r[1] for r in pairs], device)
    out = {"n_requests": len(pairs), "exe": args.exe, "entry": entry}
    lead = tuple(core) if core is not None else ()
    t0 = time.perf_counter()
    if args.sample:
        eps = torch.from_numpy(prng.normal(prng.PRNGKey(args.seed),
                                           (len(pairs), args.sample, int(meta["zdim"])))).to(device)
        y = program(*lead, d, q, eps).cpu().numpy()
        rows = [y[i] for i in range(len(pairs))]  # one panel row per cell
        out["samples_per_request"] = args.sample
        if args.joint:
            out["joint"] = True
    else:
        res = program(*lead, d, q)
        y, var = res if entry != "mean" else (res, None)
        y = y.cpu().numpy()
        rows = [y]
        if args.var:
            out["posterior_var"] = [round(float(v0), 6) for v0 in var.cpu()]
    out["latency_s"] = round(time.perf_counter() - t0, 4)
    if args.repeat > 0:
        out.update(_repeat_throughput(program, d, q, P, Q, args.repeat))
    if args.sustained > 0:
        out.update(_sustained_throughput(program, d, q, P, Q, args.sustained))
    os.makedirs(args.outdir, exist_ok=True)
    panel = os.path.join(args.outdir, "served.png")
    save_panel(panel, rows)
    npz = os.path.join(args.outdir, "served.npz")
    np.savez_compressed(npz, images=y, objects=np.asarray([r[0] for r in pairs], np.int32),
                        views=np.asarray([r[1] for r in pairs], np.int32))
    out["panel"], out["npz"] = panel, npz
    print(json.dumps(out))


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
                   help="compiled-program artifact from --export_exe: torch.export "
                        "programs (weights baked in, symbolic batch) answered "
                        "without rebuilding any model — means by default, --var / "
                        "--sample K [--joint] select the uncertainty entries")
    p.add_argument("--export_exe", default=None, metavar="PATH",
                   help="with --state: serialize the whole serving surface "
                        "(torch.export, state baked in, batch and sample count "
                        "symbolic) — mean/var/sample/sample_joint programs plus the "
                        "stateful observe/predict_core/sample_core/sample_joint_core "
                        "entries with the initial core in PATH.core.npz — to PATH* "
                        "+ PATH.meta.json, then exit")
    p.add_argument("--exe_platforms", default=None,
                   help="--export_exe: comma-separated devices to export for (cuda, "
                        "cpu; default: --device). An exported program records its "
                        "device and is refused on another")
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
    p.add_argument("--core", default=None, metavar="NPZ",
                   help="--exe: serve from this (previously observe-updated) "
                        "posterior core instead of the exported initial one — "
                        "means/variances via the predict_core entry, posterior draws "
                        "via --sample K [--joint] (the sample_core entries)")
    p.add_argument("--save_core", default=None, metavar="NPZ",
                   help="--exe --observe: write the updated posterior core here "
                        "(feed back via --core)")
    p.add_argument("--outdir", default=".")
    args = p.parse_args(argv)

    if (args.state is None) == (args.exe is None):
        raise SystemExit("serve: pass exactly one of --state or --exe")
    if args.exe:
        if args.export_exe:
            raise SystemExit("serve: --export_exe needs --state")
        if args.stdin:
            if args.requests or args.sample or args.repeat \
                    or args.sustained or args.var or args.observe:
                raise SystemExit(
                    "serve: --exe --stdin is a persistent loop (requests "
                    "and 'observe <npz>' are input LINES); drop the other "
                    "flags"
                )
            device = resolve_device(args.device)
            set_float32_precision("float32")
            core, meta = load_compiled_program(args.exe, "core", device)
            if args.core:
                core = _load_user_core(args.core, args.exe, device)
            _serve_stdin_loop(args, grid=meta["grid"], image_shape=meta["image_shape"],
                              device=device, ready={"exe": args.exe},
                              **_exe_surface(args.exe, core, device))
            return
        if args.observe and args.save_core is None:
            raise SystemExit(
                "serve: --exe --observe needs --save_core for the updated "
                "posterior core (answerable later via --core)"
            )
        if args.requests is None and not args.observe:
            raise SystemExit("serve: --exe needs --requests (or --observe)")
        if args.joint and not args.sample:
            raise SystemExit("serve: --joint modifies --sample; pass --sample K")
        if args.sample and args.var:
            raise SystemExit(
                "serve: --sample decodes posterior draws; --var reports the "
                "diagonal of the same posterior — pass one of them"
            )
        if (args.repeat or args.sustained) and (
                args.sample or args.var or args.observe or args.core):
            raise SystemExit(
                "serve: --repeat/--sustained (throughput modes) time the"
                " baked posterior-mean program; drop the other flags"
            )
        _serve_exe(args)
        return

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

    if args.export_exe:
        if args.stdin or args.sample or args.repeat or args.var \
                or args.sustained or args.observe:
            raise SystemExit("serve: --export_exe only serializes; answer "
                             "requests from the artifact via --exe (fold new "
                             "observations into the .srv state first with "
                             "--observe, then re-export)")
        emeta = export_compiled_program(
            model, state, args.export_exe, x_map=x_map, extra_effects=extra,
            platforms=tuple(p0 for p0 in (args.exe_platforms or device.type).split(",") if p0),
        )
        print(json.dumps({"export_exe": args.export_exe, **emeta}))
        return

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
        _serve_stdin_loop(args, grid=(P, Q), image_shape=model.image_shape, device=device,
                          **_state_surface(model, state, x_map, extra, meta))
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
        y = sample_images(model, state, d, q, prng.PRNGKey(args.seed),
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
