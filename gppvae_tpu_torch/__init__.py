"""gppvae_tpu_torch — the PyTorch / CUDA port of gppvae_tpu for one NVIDIA H100.

The JAX package `gppvae_tpu` is the reference this port is held against;
each module here mirrors the one of the same name there. This package
imports `torch` and never `jax`. The framework-free parts of the JAX package
(`gppvae_tpu.data`, `gppvae_tpu.config.datasets`, `gppvae_tpu.utils.metrics`)
are reused as they are. They stay jax-free only while GPPVAE_COMPILE_CACHE is
unset: with it set, `gppvae_tpu/__init__.py` imports jax to wire its
compilation cache, so leave it unset where the port runs.

Layers (bottom → top):
  ops/      the two hand-written CUDA kernels (csrc/) for the GP hot path,
            their plain PyTorch versions and the device dispatch
  gp/       low-rank (Woodbury) GP prior: features, NLL, Taylor surrogate,
            predictive posterior
  models/   conv encoder/decoder (nn.Module), VAE assembly
  train/    losses, batching, the guarded Adam, train_vae / train_gppvae
  eval/     out-of-sample GP-predictive generation and pixel MSE
  convert   flax param tree → state_dict and GP tensors
"""

__version__ = "0.1.0"
