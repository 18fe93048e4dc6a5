"""Conv VAE encoder/decoder. Mirrors gppvae_tpu.models."""

from gppvae_tpu_torch.models.vae import UPSAMPLES, VAE, ConvDecoder, ConvEncoder, encode_all

__all__ = ["UPSAMPLES", "VAE", "ConvDecoder", "ConvEncoder", "encode_all"]
