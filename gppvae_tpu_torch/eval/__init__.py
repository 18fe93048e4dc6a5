"""Out-of-sample evaluation. Mirrors gppvae_tpu.eval.oos (no panels)."""

from gppvae_tpu_torch.eval.oos import pixel_mse, predict_heldout

__all__ = ["pixel_mse", "predict_heldout"]
