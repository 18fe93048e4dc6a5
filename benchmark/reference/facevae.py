"""GPPVAE-joint over FaceVAE, in plain PyTorch, written from the model's
description.

FaceVAE is the face model of the GPPVAE paper (Casale et al., NeurIPS 2018,
arXiv:1810.11738, section 4.2; github.com/fpcasale/GPPVAE,
pysrc/faceplace/vae.py, FaceVAE(img_size=128, nf=32, zdim=256, steps=5,
colors=3, act='elu')). With S stages of widths f_1..f_S (nf each) and ELU
after every convolution but the decoder's last:

  encoder   per stage s: h ← ELU(conv3x3(h), stride 1, padding 1), then
            h ← ELU(conv3x3(h), stride 2, padding 1); stage 1 maps the
            image's channels to f_1; flatten in (H, W, C) order;
            μ = dense(h), log σ² = dense(h), each from the flat features
  decoder   h = dense(z), linear, reshaped to (h0, w0, f_1) in (h, w, c)
            order, h0 = H / 2^S; per stage nearest-resize x2, then
            ELU(conv3x3, padding 1), then conv3x3, padding 1, with ELU
            after it in every stage but the last; stage s maps to
            f_{s+1} and the last stage to the image's channels (its
            second convolution C -> C, upstream's last
            Conv2dCellUp(nf, colors, act2='linear')): logits,
            ŷ = sigmoid

Departures from the upstream file, each as the program takes them (the
configuration's `assumed` lists them): the flatten and the reshape are in
(H, W, C) order; the second head is log σ², where upstream's is
softplus(dense) = σ; the sigmoid of the port's likelihood is applied to
the decoder's output, which upstream takes as the image.

The GP prior, the epoch, the loss, both Adams and the precisions are
gppvae.py's, reused by import: only the VAE differs, so `GPPVAE` overrides
the three methods that call it (`means`, `images`, `loss`; `follow` calls
`loss`). The module fulfils the contract of a configuration's reference
(harness/manifest.py): `vae_shapes`, `vae_flops` and `GPPVAE`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import gppvae as base
from benchmark.reference.gppvae import SAT_BOUND, Arith, feature_rows
from benchmark.yardstick import flops


def vae_shapes(model: dict, image_shape) -> dict:
    """Every parameter's shape, by the program's name, in draw order, for a
    configuration's `model` (zdim, enc_features, dec_features)."""
    zdim, enc, dec = model["zdim"], model["enc_features"], model["dec_features"]
    H, W, C = image_shape
    shapes = {}
    cin, h, w = C, H, W
    for s, f in enumerate(enc):
        for i, c in ((2 * s, cin), (2 * s + 1, f)):
            shapes[f"encoder.convs.{i}.weight"] = (f, c, 3, 3)
            shapes[f"encoder.convs.{i}.bias"] = (f,)
        cin, h, w = f, -(-h // 2), -(-w // 2)
    for head in ("head_mu", "head_logvar"):
        shapes[f"encoder.{head}.weight"] = (zdim, h * w * cin)
        shapes[f"encoder.{head}.bias"] = (zdim,)
    depth = len(dec)
    h0, w0, f0 = H // 2**depth, W // 2**depth, dec[0]
    shapes["decoder.dense.weight"] = (h0 * w0 * f0, zdim)
    shapes["decoder.dense.bias"] = (h0 * w0 * f0,)
    cin = f0
    for s, f in enumerate((*dec[1:], C)):
        for i, c in ((2 * s, cin), (2 * s + 1, f)):
            shapes[f"decoder.convs.{i}.weight"] = (f, c, 3, 3)
            shapes[f"decoder.convs.{i}.bias"] = (f,)
        cin = f
    return shapes


def vae_flops(model: dict, image_shape) -> tuple[int, int]:
    """The forward FLOP of one image through the encoder and through the
    decoder, by yardstick/flops.py's convention. The encoder is counted
    directly. The decoder is priced in its least-MAC form, as train_mfu
    states it: each stage's first convolution, after the resize, as the
    2x2 sub-pixel form of the merged taps at the low resolution
    (flops.decoder_fwd_flops' 'subpixel' term), its second as a 3x3 at the
    doubled size; the last stage's map to the image's channels."""
    zdim, enc, dec = model["zdim"], model["enc_features"], model["dec_features"]
    H, W, C = image_shape
    e, cin, h, w = 0, C, H, W
    for f in enc:
        e += flops._conv(h, w, cin, f)
        h, w = -(-h // 2), -(-w // 2)
        e += flops._conv(h, w, f, f)
        cin = f
    e += 2 * flops._dense(h * w * cin, zdim)
    depth = len(dec)
    h, w, cc = H // 2**depth, W // 2**depth, dec[0]
    d = flops._dense(zdim, h * w * cc)
    for f in (*dec[1:], C):
        d += 2 * (h + 1) * (w + 1) * (4 * cc) * (4 * f)
        h, w = 2 * h, 2 * w
        d += flops._conv(h, w, f, f)
        cc = f
    return e, d


def _dense(p, name, x, a: Arith):
    return F.linear(a.q(x), a.q(p[name + ".weight"]), a.cast(p[name + ".bias"]))


def _conv(p, name, x, a: Arith, stride: int):
    return F.conv2d(a.q(x), a.q(p[name + ".weight"]), a.cast(p[name + ".bias"]),
                    stride=stride, padding=1)


def encode(p: dict, y: torch.Tensor, a: Arith, depth: int):
    """(μ, log σ²) of NHWC images."""
    h = a.cast(y).permute(0, 3, 1, 2)
    for s in range(depth):
        h = F.elu(_conv(p, f"encoder.convs.{2 * s}", h, a, 1))
        h = F.elu(_conv(p, f"encoder.convs.{2 * s + 1}", h, a, 2))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return _dense(p, "encoder.head_mu", h, a), _dense(p, "encoder.head_logvar", h, a)


def decode(p: dict, z: torch.Tensor, a: Arith, image_shape, dec_features):
    """NHWC logits of latents z."""
    H, W, _ = image_shape
    depth = len(dec_features)
    h0, w0 = H // 2**depth, W // 2**depth
    h = _dense(p, "decoder.dense", a.cast(z), a)
    h = h.reshape(z.shape[0], h0, w0, dec_features[0]).permute(0, 3, 1, 2)
    for s in range(depth):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = F.elu(_conv(p, f"decoder.convs.{2 * s}", h, a, 1))
        h = _conv(p, f"decoder.convs.{2 * s + 1}", h, a, 1)
        if s + 1 < depth:
            h = F.elu(h)
    return h.permute(0, 2, 3, 1)


class GPPVAE(base.GPPVAE):
    """gppvae.GPPVAE with FaceVAE in place of the program's default VAE."""

    def means(self, images, block: int = 256) -> torch.Tensor:
        """Phase A: μ of every row."""
        with torch.no_grad(), self.a.scope():
            return torch.cat([encode(self.vae, images[s:s + block], self.a, len(self.enc))[0]
                              for s in range(0, images.shape[0], block)])

    def images(self, z, block: int = 256) -> torch.Tensor:
        with torch.no_grad(), self.a.scope():
            return torch.cat([torch.sigmoid(decode(self.vae, z[s:s + block], self.a,
                                                   self.image_shape, self.dec))
                              for s in range(0, z.shape[0], block)])

    def loss(self, coeffs, y, pos, w, eps, d, q, n_train: int, vae, gp):
        """One minibatch's loss at the parameters `vae`, `gp` (gppvae.py's
        terms)."""
        a, bs = self.a, pos.shape[0]
        w, eps = a.cast(w), a.cast(eps)
        mu, logvar = encode(vae, y, a, len(self.enc))
        z = mu + torch.exp(0.5 * logvar) * eps
        logits = decode(vae, z, a, self.image_shape, self.dec)
        D = math.prod(self.image_shape)
        var = self.sigma_y ** 2
        sq = torch.sum(((a.cast(y) - torch.sigmoid(logits)) ** 2).reshape(bs, -1), dim=1)
        recon = sq / (2.0 * var) + 0.5 * D * math.log(2.0 * math.pi * var)
        if self.sat > 0:
            recon = recon + self.sat * torch.sum(
                (F.relu(torch.abs(logits) - SAT_BOUND) ** 2).reshape(bs, -1), dim=1)
        pen = -0.5 * torch.sum(logvar, dim=1)
        v = feature_rows(gp["X"], gp["W"], d, q)
        gp_term = (torch.sum(w * torch.sum(coeffs["dZ"][pos] * z, dim=1))
                   + torch.sum(w * torch.sum(coeffs["dV"][pos] * v, dim=1))
                   + torch.sum(w) / n_train * (torch.sum(coeffs["dlog_vs"] * gp["log_vs"])
                                               + torch.sum(coeffs["dlog_vn"] * gp["log_vn"])))
        return (torch.sum(w * recon) + torch.sum(w * pen) + gp_term) / bs
