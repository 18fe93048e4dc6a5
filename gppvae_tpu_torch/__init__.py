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
  models/   conv encoder/decoder (nn.Module), VAE assembly, the CVAE baseline
  train/    losses, batching, the guarded Adam, train_vae / train_gppvae
            (checkpoints, resume, panels, a profiler trace) / train_cvae
  eval/     out-of-sample GP-predictive generation and pixel MSE, the
            generate CLI, the serving path (fold once, then predict,
            sample, observe; the serve CLI), PNG panels and history plots
  checkpoint/ torch.save trees with a format-version sidecar
  data/     rotated-digits and face-view grid datasets (numpy), build-data,
            the bundled 8×8 handwritten digits (digits8x8.npz)
  config/   the --data flag → dataset builder
  utils/    JSONL metrics logger, the torch.profiler hook
  convert   flax param tree → state_dict and GP tensors, a JAX server state

`python -m gppvae_tpu_torch <command>` runs build-data, train-vae,
train-gppvae, train-cvae, generate, serve and plot; `validate_torch.py` at
the repository's root runs the paper's accuracy protocol on them.
"""

__version__ = "0.1.0"
