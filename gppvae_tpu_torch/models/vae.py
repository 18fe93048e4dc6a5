"""Convolutional VAE encoder/decoder (nn.Module).

Counterpart of gppvae_tpu/models/vae.py. The public layout is the JAX
package's: images are NHWC (N, H, W, C) float32, latents (N, zdim), and the
decoder returns NHWC logits. The activations stay NHWC throughout: each
3×3 convolution goes through `_conv3x3`, which on a float32 CUDA tensor
runs the port's kernels (ops/conv3x3.py: the conv, its bias and ELU in one
launch, NHWC in and out) and otherwise the aten ops on the NCHW view of the
same memory (F.conv2d, F.elu); the weights stay nn.Conv2d's (OIHW), so
the state_dict is the same in either case.

Two layout facts make the converted flax weights give the same function:
  * flax `padding="SAME"` at stride 2 pads (lo, hi) = (0, 1) on an even
    axis; `Conv2d(padding=1)` would pad (1, 1). The encoder's stride-2 conv
    is unpadded and takes that padding per side (`_same_pad`): the kernels
    fold it into their loads, the aten ops F.pad first;
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

`upsample='subpixel'` is the JAX package's other lowering of the resize
and the conv (gppvae_tpu/models/vae.py:193-254, its default 'dilated'
form), with the same parameters and state_dict. In float32 the two
lowerings are one function to ~1e-6, and the port runs the resize forward
for it: on an H100 the tap-merged lowering was slower per epoch at digits
32² (PERF.md, Findings). In bfloat16 they are two functions: flax casts
the 3×3 kernel to bfloat16 and sums its taps into a 4×4 kernel in
bfloat16, so the merged kernel's entries are rounded, and the resize
forward was as far from flax's bfloat16 decoder as that is from float32.
So in bfloat16 the port runs the JAX package's lowering, `_upconv`: the
taps summed in bfloat16 in XLA's order (`_merge_taps`, under autograd, so
the 3×3 weight's gradient flows back through the sums), one stride-2
transposed conv with that kernel, then the bias added in bfloat16, as
flax's `y + bias`. One behaviour per dtype, no switch; the float32 polish
switch changes the lowering with the dtype.

A layer whose weight tensor parallelism split (parallel/tensor.py: the
layer's `tp_group` is set, its weight is this rank's block of output
features) runs column-parallel: copy_to_model → the product with the block,
without the bias → gather_columns (the channel dimension: NHWC's last in
`_conv3x3`'s kernel path, NCHW's second in the aten ops, the last of a
dense output) → + the whole bias (→ ELU). Adding the bias after the gather
keeps its gradient whole and alike on every rank of the model row. The
decoder reshapes its dense output as (h, w, c) after the gather, so the
feature order is the unsplit one.

`vae_layout` picks one of two layouts of the same widths (`features`,
`zdim`), S = len(features) stages each way:
  * 'port' (the default) is the JAX package's VAE, as above: one 3×3
    convolution per stage, stride 2 down and resize ×2 then a convolution
    up, and a hidden dense layer of 8·zdim units, ELU, in front of the
    heads;
  * 'facevae' is FaceVAE, the face model of the GPPVAE paper (Casale et
    al. 2018, §4.2; github.com/fpcasale/GPPVAE, pysrc/faceplace/vae.py,
    FaceVAE(img_size=128, nf=32, zdim=256, steps=5, act='elu')). Encoder:
    per stage h ← ELU(conv3×3(h)), stride 1, then h ← ELU(conv3×3(h)),
    stride 2; both pad (1, 1) as `nn.Conv2d(..., padding=1)` does, so the
    padding is the conv's own, not the explicit (0, 1) of 'SAME'; flatten
    (H, W, C); μ and log σ² are two dense heads on the flat features,
    with no hidden layer. Decoder: h = dense(z), linear, reshaped
    (h, w, c); per stage nearest ×2, then ELU(conv3×3), then a second
    conv3×3, both padding 1; a stage maps to the next width
    (features[1:]) and the last to the image's channels, whose second
    conv (C → C) has no ELU and gives the logits: upstream's last
    Conv2dCellUp(nf, colors, act2='linear'). The state_dict stays flat:
    `encoder.convs.{0..2S−1}` alternate stride 1 and stride 2,
    `encoder.head_mu` / `encoder.head_logvar`, `decoder.dense`,
    `decoder.convs.{0..2S−1}` in pairs per stage; there is no
    `decoder.out`. Where it departs from the upstream file: the flatten
    and the decoder's reshape are in (H, W, C) order, as the port's; the
    second head is log σ², which the trainer and the Taylor surrogate
    read, where upstream's is softplus(dense) = σ; the logits go through
    the sigmoid of the port's likelihood, where upstream takes the last
    conv's output as the image. 'subpixel' in bfloat16 runs each stage's
    first convolution as `_upconv`.
Each forward of either half counts the convolutions it launched in the
tracer's counter `vae.conv3x3`, tallied at each launch and added with one
`count` per half.

The architecture is six values, `ARCH_DEFAULTS`' keys: zdim, the encoder's
and the decoder's widths, the decoder's upsample, the compute dtype and the
layout. A trainer's config holds them, a run records them (config.json, a
.srv meta), and every reader rebuilds the VAE from such a record through
`vae_from_record`; `add_arch_flags` / `arch_from_flags` are the trainers'
flags for them.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gppvae_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_torch
from gppvae_tpu_torch.parallel.collectives import copy_to_model, gather_columns
from gppvae_tpu_torch.utils import prng
from gppvae_tpu_torch.utils.timers import count

UPSAMPLES = ("resize", "subpixel")
LAYOUTS = ("port", "facevae")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the architecture's defaults: the trainers' configs and flags, the VAE's
# signature and a record that predates one of the values all read them here
ARCH_DEFAULTS = {
    "zdim": 16,
    "enc_features": (32, 64, 128),
    "dec_features": (128, 64, 32),
    "dec_upsample": "resize",
    "compute_dtype": "float32",
    "vae_layout": "port",
}
CONV_COUNTER = "vae.conv3x3"


def compute_dtype(name: str) -> torch.dtype:
    """The VAE's compute dtype for a --dtype value."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}; want one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


_DTYPE = COMPUTE_DTYPES[ARCH_DEFAULTS["compute_dtype"]]


def _check_layout(vae_layout: str) -> None:
    if vae_layout not in LAYOUTS:
        raise ValueError(f"unknown vae_layout {vae_layout!r}; want one of {LAYOUTS}")


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
    module gives the same values. A 'facevae' layout, which has no flax
    tree, is drawn by the same rule under the names such a module would
    give its layers: `Conv_i` for the i-th convolution of a half,
    `Dense_0` for the decoder's dense layer and the heads under their own
    names."""
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


def _conv3x3(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, same=None,
             elu: bool = False) -> torch.Tensor:
    """ELU(layer(x)) (or layer(x)) of an NHWC x, NHWC out; `same` is the
    explicit 'SAME' padding (F.pad's order) of an unpadded layer, or None.
    A float32 CUDA tensor runs the port's kernels (ops/conv3x3.py, also in
    a graph that torch.export or torch.compile traces) with the padding
    folded into their loads; anything else the plain version (CPU) or the
    aten ops of `_conv` (bfloat16 on the card, a split layer on the CPU) on
    the NCHW view."""
    group = getattr(layer, "tp_group", None)
    pad = layer.padding[0]
    w0, w1, h0, h1 = same or (0, 0, 0, 0)
    pads = (h0 + pad, h1 + pad, w0 + pad, w1 + pad)
    stride = layer.stride[0]
    if x.is_cuda and dtype == torch.float32:
        x = x.contiguous()
        if group is None:
            return conv3x3(x, layer.weight, layer.bias, stride, pads, elu)
        y = conv3x3(copy_to_model(group, x), layer.weight, None, stride, pads)
        y = gather_columns(group, y, -1) + layer.bias
        return F.elu(y) if elu else y
    if group is None and not x.is_cuda:
        return conv3x3_torch(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                             stride, pads, elu)
    h = x.permute(0, 3, 1, 2)
    h = _conv(layer, h if same is None else F.pad(h, same), dtype)
    return (F.elu(h) if elu else h).permute(0, 2, 3, 1)


def _up2(h: torch.Tensor) -> torch.Tensor:
    """Nearest resize ×2 of an NHWC h, on its NCHW view (NHWC out)."""
    return F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)


def _merge_taps(w: torch.Tensor) -> torch.Tensor:
    """The 4×4 kernel (f, cin, 4, 4) of nearest-resize ×2 followed by the
    3×3 kernel `w` (f, cin, 3, 3), in w's dtype: per axis the taps
    (w0, w1, w2) become (w0, w0 + w1, w1 + w2, w2), the JAX package's tap
    map T (gppvae_tpu/models/vae.py:245-248). Rows first, then columns, each
    sum rounded: XLA evaluates that einsum as two contractions in this
    order, each rounded to the compute dtype."""
    for dim in (2, 3):
        a, b, c = w.unbind(dim)
        w = torch.stack((a, a + b, b + c, c), dim)
    return w


def _upconv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """nearest-resize ×2 then `layer` (3×3, padding 1) as the JAX package's
    'dilated' lowering: the merged 4×4 kernel over the input dilated by 2
    with padding 2, which is a stride-2 transposed conv with the kernel
    flipped and padding 1; the bias is added after the conv's rounding.
    Column-parallel as `_conv` when the layer's weight is split: the merge
    acts on this rank's block of output features."""
    group = getattr(layer, "tp_group", None)
    w = _merge_taps(layer.weight.to(dtype)).flip(2, 3).transpose(0, 1)
    x = x.to(dtype)
    if group is not None:
        x = copy_to_model(group, x)
    y = F.conv_transpose2d(x, w, None, stride=2, padding=1)
    if group is not None:
        y = gather_columns(group, y, 1)
    return y + layer.bias.to(dtype)[:, None, None]


class ConvEncoder(nn.Module):
    """3×3 conv stack → flatten (H, W, C) → (μ, log σ²): 'port', stride-2
    convs and a hidden dense layer; 'facevae', a stride-1 and a stride-2
    conv per stage and the heads on the flat features (module docstring)."""

    def __init__(self, zdim: int, image_shape: Sequence[int], features: Sequence[int],
                 dtype: torch.dtype = _DTYPE, vae_layout: str = ARCH_DEFAULTS["vae_layout"]):
        super().__init__()
        _check_layout(vae_layout)
        self.dtype, self.vae_layout = dtype, vae_layout
        H, W, C = image_shape
        self.convs = nn.ModuleList()
        self.pads = []  # each conv's explicit F.pad of its input: 'SAME' in 'port'
        cin = C
        for f in features:
            if vae_layout == "facevae":
                self.convs.append(nn.Conv2d(cin, f, 3, padding=1))
                self.convs.append(nn.Conv2d(f, f, 3, stride=2, padding=1))
                self.pads += [None, None]
            else:
                self.convs.append(nn.Conv2d(cin, f, 3, stride=2))
                (h0, h1), (w0, w1) = _same_pad(H), _same_pad(W)
                self.pads.append((w0, w1, h0, h1))
            cin = f
            H, W = -(-H // 2), -(-W // 2)
        flat = H * W * cin
        if vae_layout == "port":
            self.dense = nn.Linear(flat, 2 * zdim * 4)
            flat = 2 * zdim * 4
        self.head_mu = nn.Linear(flat, zdim)
        self.head_logvar = nn.Linear(flat, zdim)

    def forward(self, y: torch.Tensor):
        dt = self.dtype
        h = y
        launched = 0
        for conv, pad in zip(self.convs, self.pads):
            h = _conv3x3(conv, h, dt, pad, elu=True)
            launched += 1
        count(CONV_COUNTER, launched)
        h = h.reshape(h.shape[0], -1)  # flatten H, W, C
        if self.vae_layout == "port":
            h = F.elu(_dense(self.dense, h, dt))
        return (_dense(self.head_mu, h, dt).float(),
                _dense(self.head_logvar, h, dt).float())


class ConvDecoder(nn.Module):
    """Dense → reshape (h, w, c) → per stage nearest-resize ×2 and a 3×3
    conv → 3×3 conv to C logit channels ('port'); or per stage two 3×3
    convs, the last stage's to C channels and its second linear
    ('facevae'); returned NHWC float32. 'subpixel' in bfloat16 runs each
    stage's first conv as `_upconv` (the module docstring)."""

    def __init__(self, zdim: int, image_shape: Sequence[int], features: Sequence[int],
                 upsample: str = ARCH_DEFAULTS["dec_upsample"], dtype: torch.dtype = _DTYPE,
                 vae_layout: str = ARCH_DEFAULTS["vae_layout"]):
        super().__init__()
        if upsample not in UPSAMPLES:
            raise ValueError(f"unknown upsample {upsample!r}; want one of {UPSAMPLES}")
        _check_layout(vae_layout)
        self.upsample, self.dtype, self.vae_layout = upsample, dtype, vae_layout
        H, W, C = image_shape
        depth = len(features)
        self.h0, self.w0 = H // 2**depth, W // 2**depth
        if self.h0 * 2**depth != H or self.w0 * 2**depth != W:
            raise ValueError(f"image {H}×{W} not divisible by 2^{depth}; adjust features")
        self.f0 = features[0]
        self.dense = nn.Linear(zdim, self.h0 * self.w0 * self.f0)
        self.convs = nn.ModuleList()
        cin = self.f0
        if vae_layout == "facevae":
            for f in (*features[1:], C):
                self.convs.append(nn.Conv2d(cin, f, 3, padding=1))
                self.convs.append(nn.Conv2d(f, f, 3, padding=1))
                cin = f
        else:
            for f in features:
                self.convs.append(nn.Conv2d(cin, f, 3, padding=1))
                cin = f
            self.out = nn.Conv2d(cin, C, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        facevae = self.vae_layout == "facevae"
        h = _dense(self.dense, z, dt)
        if not facevae:
            h = F.elu(h)
        h = h.reshape(z.shape[0], self.h0, self.w0, self.f0)  # NHWC
        merged = self.upsample == "subpixel" and dt == torch.bfloat16
        convs = list(self.convs)  # a slice of the ModuleList would build a module per call
        per_stage = 2 if facevae else 1
        launched = 0
        for s in range(0, len(convs), per_stage):
            if merged:
                h = F.elu(_upconv(convs[s], h.permute(0, 3, 1, 2), dt)).permute(0, 2, 3, 1)
            else:
                h = _conv3x3(convs[s], _up2(h), dt, elu=True)
            launched += 1
            if facevae:
                h = _conv3x3(convs[s + 1], h, dt, elu=s + 2 < len(convs))
                launched += 1
        if not facevae:
            h = _conv3x3(self.out, h, dt)
            launched += 1
        count(CONV_COUNTER, launched)
        return h.float()  # NHWC logits


class VAE(nn.Module):
    """Encoder + decoder; one state_dict for the vae_weights handoff.
    `key` (a prng key or an int seed) gives flax's init of the JAX
    package's `VAE.init(key, ...)` (`flax_init_`); without it the layers
    keep torch's construction values, for a caller that loads a state_dict
    next. `vae_layout`: 'port' or 'facevae' (the module docstring)."""

    def __init__(self, zdim: int, image_shape: Sequence[int],
                 enc_features: Sequence[int] = ARCH_DEFAULTS["enc_features"],
                 dec_features: Sequence[int] = ARCH_DEFAULTS["dec_features"],
                 upsample: str = ARCH_DEFAULTS["dec_upsample"],
                 key=None,
                 dtype: torch.dtype = _DTYPE,
                 vae_layout: str = ARCH_DEFAULTS["vae_layout"]):
        super().__init__()
        self.zdim = zdim
        self.image_shape = tuple(image_shape)
        self.vae_layout = vae_layout
        self.encoder = ConvEncoder(zdim, image_shape, enc_features, dtype, vae_layout)
        self.decoder = ConvDecoder(zdim, image_shape, dec_features, upsample, dtype, vae_layout)
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


def vae_from_record(record: Mapping, image_shape: Sequence[int], *,
                    dtype: torch.dtype | None = None, key=None) -> VAE:
    """The VAE of a recorded architecture, the one way the package builds
    one. `record`: a run's config.json, a .srv meta or a trainer's config
    (`vars(config)`), other keys ignored; a value it lacks reads as its
    `ARCH_DEFAULTS` entry, which is what an artifact written before that
    value was recorded was built with. `key` gives flax's init (`VAE`).

    The dtype: the record's `compute_dtype`, unless `dtype` is given. So
    generate and serve build a bfloat16 run in bfloat16, with a float32
    polish tail or without, as the JAX package's generate and serve do;
    load_final, which rebuilds where the trainer ended, passes float32 for a
    run that ended in a polish tail."""
    arch = {k: record.get(k, v) for k, v in ARCH_DEFAULTS.items()}
    return VAE(int(arch["zdim"]), image_shape, tuple(arch["enc_features"]),
               tuple(arch["dec_features"]), arch["dec_upsample"], key=key,
               dtype=compute_dtype(arch["compute_dtype"]) if dtype is None else dtype,
               vae_layout=arch["vae_layout"])


def add_arch_flags(parser, *, dtype_help: str, layout_help: str) -> None:
    """The trainers' architecture flags, each defaulting to ARCH_DEFAULTS:
    --zdim, --dtype, --dec_upsample, --vae_layout, and --enc_features /
    --dec_features as comma-separated widths. The two help texts are the
    trainer's own."""
    d = ARCH_DEFAULTS
    parser.add_argument("--zdim", type=int, default=d["zdim"])
    parser.add_argument("--dtype", default=d["compute_dtype"], choices=list(COMPUTE_DTYPES),
                        help=dtype_help)
    parser.add_argument("--dec_upsample", default=d["dec_upsample"], choices=list(UPSAMPLES))
    parser.add_argument("--vae_layout", default=d["vae_layout"], choices=list(LAYOUTS),
                        help=layout_help)
    for name in ("enc_features", "dec_features"):
        parser.add_argument(f"--{name}", default=",".join(map(str, d[name])))


def arch_from_flags(args) -> dict:
    """add_arch_flags' parsed values as a trainer config's fields."""
    def widths(s: str) -> tuple:
        return tuple(int(f) for f in s.split(","))

    return {"zdim": args.zdim, "compute_dtype": args.dtype, "dec_upsample": args.dec_upsample,
            "vae_layout": args.vae_layout, "enc_features": widths(args.enc_features),
            "dec_features": widths(args.dec_features)}


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
