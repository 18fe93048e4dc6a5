"""Conv VAE encoder/decoder and the CVAE baseline. Mirrors gppvae_tpu.models."""

from gppvae_tpu_torch.models.cvae import CVAE
from gppvae_tpu_torch.models.vae import (
    UPSAMPLES,
    VAE,
    ConvDecoder,
    ConvEncoder,
    encode_all,
    sample_reconstruction,
)

__all__ = ["CVAE", "UPSAMPLES", "VAE", "ConvDecoder", "ConvEncoder", "encode_all",
           "sample_reconstruction"]
