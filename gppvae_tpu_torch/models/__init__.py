"""Conv VAE encoder/decoder. Mirrors gppvae_tpu.models."""

from gppvae_tpu_torch.models.vae import VAE, ConvDecoder, ConvEncoder, encode_all

__all__ = ["VAE", "ConvDecoder", "ConvEncoder", "encode_all"]
