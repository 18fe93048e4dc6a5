"""Training: losses, batching, the guarded Adam and the three drivers.

Entry points (each module also runs as `python -m`):
  gppvae_tpu_torch.train.train_vae.train_vae / main        — VAE pretrain
  gppvae_tpu_torch.train.train_gppvae.train_gppvae / main  — GPPVAE dis/joint
  gppvae_tpu_torch.train.train_cvae.train_cvae / main      — CVAE baseline

The drivers are not imported here, so `python -m` loads each module once.
"""
