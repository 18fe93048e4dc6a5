"""The benchmark of gppvae_tpu_torch: one cell per run (see README.md)."""
