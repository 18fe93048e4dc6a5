"""Conv VAE encoder/decoder and the CVAE baseline. Mirrors gppvae_tpu.models."""

from gppvae_tpu_torch.models.cvae import CVAE
from gppvae_tpu_torch.models.vae import (
    ARCH_DEFAULTS,
    LAYOUTS,
    UPSAMPLES,
    VAE,
    ConvDecoder,
    ConvEncoder,
    add_arch_flags,
    arch_from_flags,
    encode_all,
    sample_reconstruction,
    vae_from_record,
)

__all__ = ["ARCH_DEFAULTS", "CVAE", "LAYOUTS", "UPSAMPLES", "VAE", "ConvDecoder", "ConvEncoder",
           "add_arch_flags", "arch_from_flags", "encode_all", "sample_reconstruction",
           "vae_from_record"]
