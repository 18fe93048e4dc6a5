"""A configuration's initial parameters, drawn on the card from the seed.

The VAE's parameters are those the configuration's reference module lists
(`vae_shapes`), in its order: weights normal with variance 1/fan_in (LeCun's
scale, as the program's own init) and biases zero, all drawn in one call and
sliced;
the GP's object features X are normal with variance 1/M; the view features
W are the fixed map of the view auxiliary that GPPVAE-joint starts from
(MATH.md §1): [1, cos kθ, sin kθ]_k of rotation angles, [1, t, ..., t^deg] of
linear positions rescaled to [-1, 1], each row unit-normalised. Both sides of
a comparison get these same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.datagen import generator


def view_features(view_aux: np.ndarray, periodic: bool, cols: int) -> torch.Tensor:
    """(Q, cols) unit rows of the fixed view map; `cols` is odd for
    rotation angles (1 + 2 frequencies)."""
    t = torch.from_numpy(np.asarray(view_aux[:, 0], np.float32))
    if periodic:
        feats = [torch.ones_like(t)]
        for k in range(1, (cols - 1) // 2 + 1):
            feats += [torch.cos(k * t), torch.sin(k * t)]
    else:
        lo, hi = torch.min(t), torch.max(t)
        t = 2.0 * (t - lo) / (hi - lo) - 1.0 if hi > lo else t * 0.0
        feats = [t**k for k in range(cols)]
    W = torch.stack(feats, dim=1)
    return W / torch.linalg.norm(W, dim=1, keepdim=True)


def view_columns(model: dict) -> int:
    """M_w, the view features' columns: `view_feature_dim`, else 1 + 2 ×
    `view_num_freqs`, as the program reads them."""
    return model.get("view_feature_dim") or 2 * model["view_num_freqs"] + 1


def make(reference, model: dict, train: dict, grid: dict, seed: int,
         device) -> tuple[dict, dict]:
    """({name: VAE tensor}, {'X', 'W', 'log_vs', 'log_vn'}) float32 on
    `device`; `reference` is the configuration's reference module."""
    g = generator(seed, 4, device)
    shapes = reference.vae_shapes(model, tuple(grid["images"].shape[1:]))
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=g, device=device)
    vae, at = {}, 0
    for name, shape in shapes.items():
        t = flat[at:at + sizes[name]].reshape(shape)
        at += sizes[name]
        if name.endswith(".bias"):
            vae[name] = torch.zeros(shape, device=device)
        else:
            vae[name] = (t / math.sqrt(sizes[name] / shape[0])).contiguous()
    P, M = int(grid["object_ids"].max()) + 1, model["obj_feature_dim"]
    gp = {"X": torch.randn(P, M, generator=g, device=device) / math.sqrt(M),
          "W": view_features(grid["view_aux"], grid["periodic_views"],
                             view_columns(model)).to(device),
          "log_vs": torch.full((1,), math.log(train["init_v_sig"]), device=device),
          "log_vn": torch.tensor(math.log(train["init_v_noise"]), device=device)}
    return vae, gp
