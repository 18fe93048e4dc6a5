"""gppvae_tpu_torch — the PyTorch / CUDA port of gppvae_tpu for one NVIDIA H100.

The JAX package `gppvae_tpu` is the reference this port is held against;
each module here mirrors the one of the same name there. This package
imports `torch` and never `jax`, and nothing of `gppvae_tpu` either: what it
needs of the JAX package's framework-free modules (the dataset builders, the
--data flag, the metrics logger) it keeps in its own copy (data/, config/,
utils/).

Layers (bottom → top):
  ops/      the two hand-written CUDA kernels (csrc/) for the GP hot path,
            their plain PyTorch versions and the device dispatch
  gp/       low-rank (Woodbury) GP prior: features, NLL, Taylor surrogate,
            predictive posterior
  models/   conv encoder/decoder (nn.Module), VAE assembly
  train/    losses, batching, the guarded Adam, train_vae / train_gppvae
  eval/     out-of-sample GP-predictive generation and pixel MSE
  data/     rotated-digits and face-view grid builders (numpy)
  config/   the --data flag → dataset builder
  utils/    JSONL metrics logger
  convert   flax param tree → state_dict and GP tensors
"""

__version__ = "0.1.0"
