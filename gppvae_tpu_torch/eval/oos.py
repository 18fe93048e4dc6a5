"""Out-of-sample conditional generation.

Counterpart of gppvae_tpu/eval/oos.py: for held-out (object, view) cells,
GP-predictive latent means from the training latents are decoded to images
(no encoder involved); pixel MSE against the true held-out images is the
parity metric.
"""

from __future__ import annotations

import torch

from gppvae_tpu_torch import gp


def oos_predict_images(decode_fn, V_star, factors: gp.GPFactors, Z: torch.Tensor,
                       v_sigs, *, group=None) -> torch.Tensor:
    """ŷ* = sigmoid(decoder(K(*,·) K⁻¹ Z)) for held-out feature rows."""
    return torch.sigmoid(decode_fn(gp.predict_latents(V_star, factors, Z, v_sigs, group=group)))


def pixel_mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_true - y_pred) ** 2)


@torch.no_grad()
def predict_heldout(model, gp_params: dict, fixed_W, Z0, d_tr, q_tr, d_ho, q_ho, y_ho,
                    *, x_map=None, extra_effects: tuple = (), row_weights=None, group=None):
    """(ŷ (n, H, W, C), pixel MSE) for the held-out rows.

    gp_params: {'X', ['W'], 'log_vs', 'log_vn', ...}; fixed_W is the
    'dis'-mode view feature matrix, used when gp_params carries no learned
    W. x_map and extra_effects: the trainer's object-kernel map and extra
    random effects (gp.build_effect_rows). row_weights: optional (N,) 0/1
    weights of the training rows; a weight-0 row (one that pads a row split)
    adds nothing to the factors or K⁻¹Z. group: a DataGroup, Z0 and the
    training rows being the rank's; the posterior core is reduced over the
    ranks and the prediction is every rank's alike."""
    W = gp_params["W"] if "W" in gp_params else fixed_W
    X = gp_params["X"]
    V_tr = gp.build_effect_rows(X, W, d_tr, q_tr, extra_effects=extra_effects, x_map=x_map)
    if row_weights is not None:
        V_tr = [v * row_weights[:, None] for v in V_tr]
    V_ho = gp.build_effect_rows(X, W, d_ho, q_ho, extra_effects=extra_effects, x_map=x_map)
    v_sig, v_noise = gp.variances_from_log(gp_params["log_vs"], gp_params["log_vn"])
    v_sigs = [v_sig.reshape(-1)[i] for i in range(len(V_tr))]
    factors = gp.factorize(V_tr, v_sigs, v_noise, group=group)
    y_pred = oos_predict_images(model.decode, V_ho, factors, Z0, v_sigs, group=group)
    return y_pred, pixel_mse(y_ho, y_pred)
