"""Convolutional VAE encoder/decoder (nn.Module).

Counterpart of gppvae_tpu/models/vae.py. The public layout is the JAX
package's: images are NHWC (N, H, W, C) float32, latents (N, zdim), and the
decoder returns NHWC logits. Only the conv stacks run in NCHW.

Two layout facts make the converted flax weights give the same function:
  * flax `padding="SAME"` at stride 2 pads (lo, hi) = (0, 1) on an even
    axis; `Conv2d(padding=1)` would pad (1, 1). The encoder pads explicitly
    (`_same_pad`) before an unpadded stride-2 conv;
  * the encoder flattens in H, W, C order and the decoder's dense output is
    reshaped as (h, w, c), as flax does.
Nearest-resize ×2 (`jax.image.resize(..., "nearest")`) is
`F.interpolate(scale_factor=2, mode="nearest")`.

`dtype` is flax's compute dtype: parameters stay float32, every conv and
dense layer casts its input, weight and bias to `dtype` (flax's
`promote_dtype`), and μ, log σ² and the logits come back float32. It is an
attribute of the modules, not an autocast region, so nothing outside the
VAE (the GP path and its kernels) ever sees a bfloat16 tensor. The trainers
flip it in place (`VAE.dtype = ...`) for the float32 polish tail.

`upsample='subpixel'` is the JAX package's other lowering of the same
function with the same parameters (gppvae_tpu/models/vae.py:193-254): it
exists there to feed the TPU's matrix unit. The port accepts the name, so
configs and checkpoints interchange, and runs the resize forward for it:
on an H100 the tap-merged transposed conv was no faster per epoch in
either dtype and slower in float32 (PERF.md, Findings).

A layer whose weight tensor parallelism split (parallel/tensor.py: the
layer's `tp_group` is set, its weight is this rank's block of output
features) runs column-parallel: copy_to_model → the product with the block,
without the bias → gather_columns (the channel dimension of NCHW, the last
of a dense output) → + the whole bias. Adding the bias after the gather
keeps its gradient whole and alike on every rank of the model row. The
decoder reshapes its dense output as (h, w, c) after the gather, so the
feature order is the unsplit one.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gppvae_tpu_torch.parallel.collectives import copy_to_model, gather_columns
from gppvae_tpu_torch.utils import prng

UPSAMPLES = ("resize", "subpixel")


def _same_pad(size: int, k: int = 3, s: int = 2) -> tuple[int, int]:
    """(lo, hi) padding of one axis for XLA/flax 'SAME' at stride s."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _flax_layer(name: str, n_dec_convs: int) -> tuple[str, str]:
    """The flax (module, layer) of one of the port's Conv2d / Linear."""
    part, rest = name.split(".", 1)
    if rest == "out":
        return part, f"Conv_{n_dec_convs}"
    if rest.startswith("convs."):
        return part, f"Conv_{rest.split('.')[1]}"
    return part, "Dense_0" if rest == "dense" else rest


def flax_init_(model: nn.Module, key) -> None:
    """flax's init of the VAE / CVAE tree from one key, in place: zero
    biases, and each kernel lecun_normal (truncated normal on (−2, 2) over
    0.8796…, variance 1/fan_in) drawn in flax's layout (HWIO, (in, out))
    from fold_in_str(key, module, layer, 1), the key flax derives for a
    layer's first parameter. `model.init(key, ...)` of the JAX package's
    module gives the same values."""
    key = prng.PRNGKey(key) if np.ndim(key) == 0 else np.asarray(key)
    n_dec_convs = len(model.decoder.convs)
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            w = m.weight
            shape = (*w.shape[2:], w.shape[1], w.shape[0])  # HWIO / (in, out)
            fan_in = math.prod(shape[:-1])
            std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
            k = prng.truncated_normal(prng.fold_in_str(key, *_flax_layer(name, n_dec_convs), 1),
                                      -2.0, 2.0, shape) * std
            k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            w.copy_(torch.from_numpy(np.ascontiguousarray(k)))
            m.bias.zero_()


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    group = getattr(layer, "tp_group", None)
    if group is None:
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    y = F.linear(copy_to_model(group, x.to(dtype)), layer.weight.to(dtype))
    return gather_columns(group, y, -1) + layer.bias.to(dtype)


def _conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    group = getattr(layer, "tp_group", None)
    if group is None:
        return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                        layer.stride, layer.padding)
    y = F.conv2d(copy_to_model(group, x.to(dtype)), layer.weight.to(dtype), None,
                 layer.stride, layer.padding)
    return gather_columns(group, y, 1) + layer.bias.to(dtype)[:, None, None]


class ConvEncoder(nn.Module):
    """Stride-2 3×3 conv stack → flatten (H, W, C) → dense → (μ, log σ²)."""

    def __init__(self, zdim: int, image_shape: Sequence[int],
                 features: Sequence[int] = (32, 64, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        H, W, C = image_shape
        self.convs = nn.ModuleList()
        cin = C
        for f in features:
            self.convs.append(nn.Conv2d(cin, f, 3, stride=2))
            cin = f
            H, W = -(-H // 2), -(-W // 2)
        self.dense = nn.Linear(H * W * cin, 2 * zdim * 4)
        self.head_mu = nn.Linear(2 * zdim * 4, zdim)
        self.head_logvar = nn.Linear(2 * zdim * 4, zdim)

    def forward(self, y: torch.Tensor):
        dt = self.dtype
        h = y.permute(0, 3, 1, 2)  # NHWC → NCHW
        for conv in self.convs:
            ph, pw = _same_pad(h.shape[2]), _same_pad(h.shape[3])
            h = F.elu(_conv(conv, F.pad(h, (pw[0], pw[1], ph[0], ph[1])), dt))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flatten H, W, C
        h = F.elu(_dense(self.dense, h, dt))
        return (_dense(self.head_mu, h, dt).float(),
                _dense(self.head_logvar, h, dt).float())


class ConvDecoder(nn.Module):
    """Dense → reshape (h, w, c) → (nearest-resize ×2 + 3×3 conv) stack →
    3×3 conv to C logit channels, returned NHWC float32. `upsample` is kept
    for the JAX package's configs; both names run the same forward."""

    def __init__(self, zdim: int, image_shape: Sequence[int],
                 features: Sequence[int] = (128, 64, 32), upsample: str = "resize",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if upsample not in UPSAMPLES:
            raise ValueError(f"unknown upsample {upsample!r}; want one of {UPSAMPLES}")
        self.upsample, self.dtype = upsample, dtype
        H, W, C = image_shape
        depth = len(features)
        self.h0, self.w0 = H // 2**depth, W // 2**depth
        if self.h0 * 2**depth != H or self.w0 * 2**depth != W:
            raise ValueError(f"image {H}×{W} not divisible by 2^{depth}; adjust features")
        self.f0 = features[0]
        self.dense = nn.Linear(zdim, self.h0 * self.w0 * self.f0)
        self.convs = nn.ModuleList()
        cin = self.f0
        for f in features:
            self.convs.append(nn.Conv2d(cin, f, 3, padding=1))
            cin = f
        self.out = nn.Conv2d(cin, C, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.elu(_dense(self.dense, z, dt))
        h = h.reshape(z.shape[0], self.h0, self.w0, self.f0).permute(0, 3, 1, 2)
        for conv in self.convs:
            h = F.elu(_conv(conv, F.interpolate(h, scale_factor=2, mode="nearest"), dt))
        return _conv(self.out, h, dt).permute(0, 2, 3, 1).float()  # NCHW → NHWC logits


class VAE(nn.Module):
    """Encoder + decoder; one state_dict for the vae_weights handoff.
    `key` (a prng key or an int seed) gives flax's init of the JAX
    package's `VAE.init(key, ...)` (`flax_init_`); without it the layers
    keep torch's construction values, for a caller that loads a state_dict
    next."""

    def __init__(self, zdim: int, image_shape: Sequence[int],
                 enc_features: Sequence[int] = (32, 64, 128),
                 dec_features: Sequence[int] = (128, 64, 32),
                 upsample: str = "resize",
                 key=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.zdim = zdim
        self.image_shape = tuple(image_shape)
        self.encoder = ConvEncoder(zdim, image_shape, enc_features, dtype)
        self.decoder = ConvDecoder(zdim, image_shape, dec_features, upsample, dtype)
        if key is not None:
            flax_init_(self, key)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of both halves."""
        return self.encoder.dtype

    @dtype.setter
    def dtype(self, dtype: torch.dtype) -> None:
        self.encoder.dtype = self.decoder.dtype = dtype

    def encode(self, y: torch.Tensor):
        return self.encoder(y)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


@torch.no_grad()
def encode_all(model: VAE, images: torch.Tensor, chunk: int) -> torch.Tensor:
    """Grad-free latent means of every row, `chunk` rows at a time (Phase A)."""
    return torch.cat([model.encode(images[s:s + chunk])[0]
                      for s in range(0, images.shape[0], chunk)])


@torch.no_grad()
def sample_reconstruction(model: VAE, y: torch.Tensor, key) -> torch.Tensor:
    """sigmoid(decode(z)) of z ~ q(z | y), for a trainer's image panel: the
    JAX package's `model.apply(params, y, key)`, ε = normal(key, μ.shape)
    (models/vae.py:28-31)."""
    mu, logvar = model.encode(y)
    eps = torch.from_numpy(prng.normal(key, tuple(mu.shape))).to(mu.device)
    return torch.sigmoid(model.decode(mu + torch.exp(0.5 * logvar) * eps))
