"""Flax param tree ↔ the port's VAE state_dict and GP tensors.

The flax tree (as numpy arrays) is
`{encoder,decoder}/{Conv_i,Dense_0,head_mu,head_logvar}/{kernel,bias}`,
optionally under a top-level "params". Conv kernels go HWIO → OIHW, Dense
kernels (in, out) → Linear (out, in). The encoder's flatten order (H, W, C)
and the decoder's (h, w, c) reshape are kept by models/vae.py itself, so no
dense weight is permuted. A flax CVAE tree has the same layer names (its
first encoder conv has C + Q input channels, its first decoder dense
zdim + Q inputs) and converts by the same rules. `server_state_from_numpy`
carries a JAX server state over whole, `train_state_from_jax` a JAX train
state with both Adams' moments, so that the port can resume, generate from
and serve a run the JAX trainer began. Every function takes numpy trees:
nothing here imports jax, flax, optax or orbax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _torch_name(part: str, layer: str, n_convs: int) -> str:
    """flax layer name → the port's module path."""
    if layer.startswith("Conv_"):
        i = int(layer[len("Conv_"):])
        if part == "decoder" and i == n_convs - 1:
            return "decoder.out"  # the final logit conv
        return f"{part}.convs.{i}"
    if layer == "Dense_0":
        return f"{part}.dense"
    return f"{part}.{layer}"  # head_mu, head_logvar


def flax_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """VAE (or CVAE) state_dict, float32 CPU tensors, from the flax param tree."""
    tree = tree.get("params", tree)
    sd = {}
    for part in ("encoder", "decoder"):
        layers = tree[part]
        n_convs = sum(1 for k in layers if k.startswith("Conv_"))
        for layer, p in layers.items():
            name = _torch_name(part, layer, n_convs)
            k = np.asarray(p["kernel"], np.float32)
            w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
            sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
    return sd


cvae_state_dict_from_flax = flax_to_state_dict  # same layer names, same rules


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of flax_to_state_dict: {"params": {encoder, decoder}}."""
    tree: dict = {"encoder": {}, "decoder": {}}
    for key, t in sd.items():
        path, kind = key.rsplit(".", 1)
        part, rest = path.split(".", 1)
        if rest == "out":
            layer = f"Conv_{sum(1 for k in sd if k.startswith('decoder.convs.') and k.endswith('.bias'))}"
        elif rest.startswith("convs."):
            layer = f"Conv_{rest.split('.')[1]}"
        elif rest == "dense":
            layer = "Dense_0"
        else:
            layer = rest
        a = t.detach().cpu().numpy()
        if kind == "weight":
            tree[part].setdefault(layer, {})["kernel"] = (
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            )
        else:
            tree[part].setdefault(layer, {})["bias"] = a
    return {"params": tree}


def gp_params_from_numpy(gp: Mapping, device: torch.device | str = "cpu",
                         dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """GP params {X, [W], log_vs, log_vn} (numpy or jax arrays) → tensors."""
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in gp.items()}


def rff_draws_from_map(map_fn) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ω, b) float32 tensors from the closure that the JAX package's
    `gp.make_rff_map` returns (features.py:155-165 closes over `omega` and
    `phase`), so that `gp.make_rff_map(draws, ...)` computes the same
    map. Reads the closure's cells; needs no jax import."""
    cells = dict(zip(map_fn.__code__.co_freevars,
                     (c.cell_contents for c in map_fn.__closure__)))
    return (torch.tensor(np.asarray(cells["omega"]), dtype=torch.float32),
            torch.tensor(np.asarray(cells["phase"]), dtype=torch.float32))


def server_state_from_numpy(state: Mapping, device: torch.device | str = "cpu"):
    """The port's eval.serving.ServerState from a JAX ServerState as numpy:
    {'core': {'M', 'G', 'Lb', 'v_noise'}, 'X', 'W', 'v_sig', 'vae_params'
    (the flax VAE tree)}, i.e. `{**s._asdict(), 'core': s.core._asdict()}`.
    Float32 tensors on `device`."""
    from gppvae_tpu_torch.eval.serving import ServerState
    from gppvae_tpu_torch.gp import PosteriorCore

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    return ServerState(
        core=PosteriorCore(**{k: t(state["core"][k]) for k in PosteriorCore._fields}),
        X=t(state["X"]), W=t(state["W"]), v_sig=t(state["v_sig"]),
        vae_params={k: v.to(device) for k, v in flax_to_state_dict(state["vae_params"]).items()},
    )


def train_state_from_jax(params: Mapping, ov_state: Mapping, og_state: Mapping, epoch: int, *,
                         template: Mapping) -> dict:
    """The port's train state (a `state_NNNN` tree of train_gppvae) from the
    JAX trainer's state as numpy trees, `epoch` epochs done.

    params: {'vae': the flax VAE tree, 'gp': {'X', ['W'], 'log_vs', 'log_vn',
    ...}}. ov_state / og_state: the Adam state of each optimizer as {'mu',
    'nu', 'count'}, mu and nu shaped like params['vae'] / params['gp'] (of
    the JAX trainer's optax state: `state["inner"][0]`, a ScaleByAdamState).
    template: a train state of the port for the same configuration (what
    `train_gppvae._train_state` gives for a freshly set-up run): it supplies
    the parameter order (the VAE's named_parameters, the sorted GP names),
    the Adams' hyperparameters and what the JAX state does not carry (the
    stream's name, the shape record, the object kernel's draws).
    Returns a new tree; `checkpoint.save_tree` writes it, `--resume` reads it."""
    def adam(template_sd: Mapping, moments: Mapping, names, convert) -> dict:
        mu, nu, count = convert(moments["mu"]), convert(moments["nu"]), float(moments["count"])
        sd = dict(template_sd)
        sd["steps"] = int(count)
        sd["adam"] = dict(sd["adam"], state={
            i: {"step": torch.tensor(count), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for i, name in enumerate(names)})
        return sd

    state = dict(template)
    state["vae"] = flax_to_state_dict(params["vae"])
    state["gp"] = gp_params_from_numpy(params["gp"])
    if list(state["vae"]) and set(state["vae"]) != set(template["vae"]):
        raise ValueError("the flax tree converts to other parameters than the template's VAE: "
                         f"{sorted(set(state['vae']) ^ set(template['vae']))}")
    if set(state["gp"]) != set(template["gp"]):
        raise ValueError(f"GP params {sorted(state['gp'])}; the template has "
                         f"{sorted(template['gp'])}")
    state["opt_vae"] = adam(template["opt_vae"], ov_state, list(template["vae"]),
                            flax_to_state_dict)
    state["opt_gp"] = adam(template["opt_gp"], og_state, sorted(template["gp"]),
                           gp_params_from_numpy)
    state["epoch"] = int(epoch)
    return state
