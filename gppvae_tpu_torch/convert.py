"""Flax param tree ↔ the port's VAE state_dict and GP tensors.

The flax tree (as numpy arrays) is
`{encoder,decoder}/{Conv_i,Dense_0,head_mu,head_logvar}/{kernel,bias}`,
optionally under a top-level "params". Conv kernels go HWIO → OIHW, Dense
kernels (in, out) → Linear (out, in). The encoder's flatten order (H, W, C)
and the decoder's (h, w, c) reshape are kept by models/vae.py itself, so no
dense weight is permuted.
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
    """VAE state_dict (float32 CPU tensors) from a flax VAE param tree."""
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
