"""Analytic FLOP accounting for roofline numbers.

The port's own copy of gppvae_tpu/utils/flops.py (framework-free; held equal
to the original, function by function, by tests/test_torch_utils.py). The
formulas follow models/vae.py and the phases of the GPPVAE epoch. They count
what the algorithm needs, not what a library executes: the port's
'subpixel' decoder runs the resize forward (models/vae.py), so a subpixel
price is the JAX lowering's, kept for interchange of configs.

Convention: 1 MAC = 2 FLOPs; elementwise, activation and resize traffic is
ignored (bandwidth-bound); backward = 2× forward for conv and dense layers
(grad-input + grad-weights), so fwd+bwd = 3× fwd.
"""

from __future__ import annotations


def _conv(h_out: int, w_out: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * h_out * w_out * cin * cout * k * k


def _dense(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def encoder_fwd_flops(image_shape, features, zdim: int) -> int:
    """Per-image forward FLOPs of models.ConvEncoder (stride-2 SAME convs →
    hidden dense → two zdim heads)."""
    h, w, c = image_shape
    total = 0
    cin = c
    for f in features:
        h, w = -(-h // 2), -(-w // 2)  # stride-2 SAME
        total += _conv(h, w, cin, f)
        cin = f
    hidden = 8 * zdim  # nn.Dense(2 * zdim * 4)
    total += _dense(h * w * cin, hidden)
    total += 2 * _dense(hidden, zdim)  # mu + logvar heads
    return total


def decoder_fwd_flops(image_shape, features, zdim: int,
                      upsample: str = "resize") -> int:
    """Per-image forward FLOPs of models.ConvDecoder (dense → resize×2 +
    conv stack → final conv). upsample='subpixel' prices the JAX package's
    fused rewrite: a 2×2 conv at low resolution with 4f output channels
    over an (h+1)×(w+1) padded grid, 32·(h+1)(w+1)·cin·f FLOPs against the
    resize path's 72·hw·cin·f (2.25× fewer MACs, same function)."""
    H, W, C = image_shape
    depth = len(features)
    h, w = H // (2 ** depth), W // (2 ** depth)
    cc = features[0]
    total = _dense(zdim, h * w * cc)
    for f in features:
        if upsample == "subpixel":
            total += 2 * (h + 1) * (w + 1) * (4 * cc) * (4 * f)
            h, w = h * 2, w * 2
        else:
            h, w = h * 2, w * 2
            total += _conv(h, w, cc, f)
        cc = f
    total += _conv(H, W, cc, C)
    return total


def gp_solve_flops(n: int, r: int, l: int) -> int:
    """Phase-B forward: factor_prep (Gram + projection + ‖Z‖²); the
    R-sized core (Cholesky / triangular solves) is O(R³), small but counted."""
    return 2 * n * r * (r + l) + 2 * n * l + r ** 3


def gppvae_epoch_flops(
    *,
    image_shape,
    enc_features,
    dec_features,
    zdim: int,
    n_train: int,
    n_heldout: int,
    batch_size: int,
    rank: int,
    upsample: str = "resize",
) -> dict:
    """Per-epoch FLOP breakdown of the GPPVAE epoch (train_gppvae._Loop):
    Phase A full encode, Phase B exact solve + Taylor grads (≈ 2× the
    forward's GEMMs), OOS eval, Phase C minibatch fwd+bwd over ceil(N/bs)
    batches. The run's final refresh + eval is excluded."""
    enc = encoder_fwd_flops(image_shape, enc_features, zdim)
    dec = decoder_fwd_flops(image_shape, dec_features, zdim, upsample)
    nb = -(-n_train // batch_size)
    phase_a = n_train * enc
    phase_b = 3 * gp_solve_flops(n_train, rank, zdim)  # fwd + taylor bwd
    eval_oos = n_heldout * dec + 2 * n_heldout * rank * zdim
    phase_c = 3 * nb * batch_size * (enc + dec)
    total = phase_a + phase_b + eval_oos + phase_c
    return {
        "phase_a": phase_a,
        "phase_b": phase_b,
        "eval_oos": eval_oos,
        "phase_c": phase_c,
        "total": total,
    }


def vae_epoch_flops(
    *, image_shape, enc_features, dec_features, zdim: int,
    n_train: int, n_val: int, batch_size: int, upsample: str = "resize",
) -> dict:
    """Per-epoch FLOPs of the VAE pretrain epoch (train_vae)."""
    enc = encoder_fwd_flops(image_shape, enc_features, zdim)
    dec = decoder_fwd_flops(image_shape, dec_features, zdim, upsample)
    nb = -(-n_train // batch_size)
    phase_c = 3 * nb * batch_size * (enc + dec)
    val = n_val * (enc + dec)
    return {"phase_c": phase_c, "val": val, "total": phase_c + val}


def format_tflops(flops: float) -> str:
    return f"{flops / 1e12:.3f} TF"
