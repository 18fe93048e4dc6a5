"""Training: losses, batching, the guarded Adam and the two drivers.

Entry points (each module also runs as `python -m`):
  gppvae_tpu_torch.train.train_vae.train_vae / main        — VAE pretrain
  gppvae_tpu_torch.train.train_gppvae.train_gppvae / main  — GPPVAE dis/joint

The drivers are not imported here, so `python -m` loads each module once.
"""
