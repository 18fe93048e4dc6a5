"""Conv VAE encoder/decoder and the CVAE baseline. Mirrors gppvae_tpu.models."""

from gppvae_tpu_torch.models.cvae import CVAE
from gppvae_tpu_torch.models.vae import (
    LAYOUTS,
    UPSAMPLES,
    VAE,
    ConvDecoder,
    ConvEncoder,
    encode_all,
    sample_reconstruction,
)

__all__ = ["CVAE", "LAYOUTS", "UPSAMPLES", "VAE", "ConvDecoder", "ConvEncoder", "encode_all",
           "sample_reconstruction"]
