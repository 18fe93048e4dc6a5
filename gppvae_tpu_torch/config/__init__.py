"""The --data flag's mapping onto the dataset builders."""

from gppvae_tpu_torch.config.datasets import build_dataset_from_flag

__all__ = ["build_dataset_from_flag"]
