"""Evaluation: out-of-sample conditional generation, pixel MSE, image
panels, history plots (plots.py) and the serving path. Mirrors gppvae_tpu.eval, less its
compiled-program names (not ported yet)."""

from gppvae_tpu_torch.eval.oos import oos_predict_images, pixel_mse, predict_heldout
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.eval.serving import (
    ServerState,
    build_server_state,
    load_server_state,
    predict_images,
    sample_images,
    save_server_state,
    x_map_from_meta,
)

__all__ = [
    "save_panel",
    "oos_predict_images",
    "pixel_mse",
    "predict_heldout",
    "ServerState",
    "build_server_state",
    "load_server_state",
    "predict_images",
    "sample_images",
    "save_server_state",
    "x_map_from_meta",
]
