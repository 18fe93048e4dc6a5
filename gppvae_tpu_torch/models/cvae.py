"""Conditional VAE baseline (the paper's CVAE comparison model).

Counterpart of gppvae_tpu/models/cvae.py. Casale et al. 2018 compare GPPVAE
against a CVAE conditioned on the view: the encoder sees (image, view), the
decoder reconstructs from (z, view). The view id enters the encoder as Q
constant one-hot planes after the image's channels (the public layout is
NHWC, so the concat is on the last axis; ConvEncoder then runs NCHW with
the image channels first), and the decoder as a one-hot vector after z.
The halves are the VAE's ConvEncoder / ConvDecoder with C + Q input channels
and zdim + Q latent inputs, so the compute `dtype` and `upsample` mean what
they mean there, and a flax CVAE tree converts like a VAE's
(convert.cvae_state_dict_from_flax).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gppvae_tpu_torch.models.vae import ConvDecoder, ConvEncoder, flax_init_


class CVAE(nn.Module):
    def __init__(self, zdim: int, image_shape: Sequence[int], num_views: int,
                 enc_features: Sequence[int] = (32, 64, 128),
                 dec_features: Sequence[int] = (128, 64, 32),
                 upsample: str = "resize",
                 key=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, W, C = image_shape
        self.zdim, self.num_views = zdim, num_views
        self.image_shape = tuple(image_shape)
        self.encoder = ConvEncoder(zdim, (H, W, C + num_views), enc_features, dtype)
        self.decoder = ConvDecoder(zdim + num_views, image_shape, dec_features, upsample, dtype)
        if key is not None:  # flax's CVAE.init(key, ...), as the VAE's
            flax_init_(self, key)

    def encode(self, y: torch.Tensor, q: torch.Tensor):
        onehot = F.one_hot(q, self.num_views).to(y.dtype)
        planes = onehot[:, None, None, :].expand(*y.shape[:3], self.num_views)
        return self.encoder(torch.cat([y, planes], dim=-1))

    def decode(self, z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return self.decoder(torch.cat([z, F.one_hot(q, self.num_views).to(z.dtype)], dim=-1))
