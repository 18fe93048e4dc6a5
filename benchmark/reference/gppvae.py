"""GPPVAE-joint in plain PyTorch, written from the model's description.

The model (Casale et al., NeurIPS 2018, arXiv:1810.11738; the repository's
MATH.md is its normative statement):

  encoder   stride-2 3x3 convolutions with 'SAME' padding (lo, hi) =
            (0, 1) on even sizes, ELU; flatten in (H, W, C) order; a dense
            layer of 8·zdim units, ELU; two dense heads μ and log σ²
  decoder   a dense layer to (h0, w0, f0) in (h, w, c) order, ELU; per
            stage nearest-resize x2 then a 3x3 convolution, ELU; a 3x3
            convolution to the image's channels: logits, ŷ = sigmoid
  GP prior  K = v_s·V Vᵀ + v_n·I over the N x L latents, V's rows the
            Kronecker products of the unit-normalised object and view
            features x_d ⊗ w_q, v_s = exp(log v_s), v_n = exp(log v_n) +
            1e-6; the NLL by the Woodbury identity
  epoch     Phase A encodes every training row (the means); Phase B takes
            the NLL at those latents and its gradients in Z, V and the
            log-variances; each minibatch step minimises
              Σ w·(recon + sat + pen)/bs + [Σ w·<dZ_n, z_n> +
              Σ w·<dV_n, v_n> + (Σw/N)·<dθ, θ>]/bs
            with recon = ‖y − ŷ‖²/(2σ²) + (D/2)·log 2πσ², sat = Σ
            relu(|logit| − 15)², pen = −½ Σ log σ², z = μ + σ·ε; one Adam
            (β 0.9, 0.999, ε 1e-8) for the VAE and one for (X, W, log v_s,
            log v_n), each behind a clip of the global gradient norm at 1e5
  serving   z* = U* B⁻¹ UᵀZ / v_n with U = √v_s·V, B = I + UᵀU / v_n;
            ŷ* = sigmoid(decoder(z*))

The module fulfils the contract of a configuration's reference
(harness/manifest.py): `vae_shapes`, `vae_flops` and `GPPVAE`.

Parameters are a dict keyed by the names in `vae_shapes` (convolution
weights (out, in, 3, 3), dense weights (out, in)). Everything runs in blocks
of rows so that it fits beside nothing else on the card.

Precision: 'exact' computes in float64; 'tf32' in float32 with the tensor
cores' TF32 products on; 'fp8' rounds both operands of every VAE
convolution and dense layer to float8 e4m3 with a per-tensor scale and the
rest as 'tf32'. The last two are the controls: the reference in the
precision one step below what a configuration states.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark.yardstick import flops

PRECISIONS = ("exact", "tf32", "fp8")
MIN_V_NOISE = 1e-6
SAT_BOUND = 15.0
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


class Arith:
    """How the reference computes: its dtype, its TF32 switch and the
    float8 rounding of the VAE layers' operands."""

    def __init__(self, precision: str = "exact"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; want one of {PRECISIONS}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "exact" else torch.float32

    @contextlib.contextmanager
    def scope(self):
        """TF32 products on for the lower precisions, off for 'exact'."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.precision != "exact"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A VAE operand as the arithmetic sees it."""
        t = t.to(self.dtype)
        if self.precision != "fp8":
            return t
        scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / FP8_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(self.dtype) * scale
        return t + (rounded - t.detach())  # the rounded value, the gradient straight through

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)


# -- the VAE

def _down(size: int) -> int:
    return -(-size // 2)


def vae_shapes(model: dict, image_shape) -> dict:
    """Every parameter's shape, by the program's name, in draw order, for a
    configuration's `model` (zdim, enc_features, dec_features)."""
    zdim, enc_features, dec_features = model["zdim"], model["enc_features"], model["dec_features"]
    H, W, C = image_shape
    shapes = {}
    cin, h, w = C, H, W
    for i, f in enumerate(enc_features):
        shapes[f"encoder.convs.{i}.weight"] = (f, cin, 3, 3)
        shapes[f"encoder.convs.{i}.bias"] = (f,)
        cin, h, w = f, _down(h), _down(w)
    hidden = 8 * zdim
    shapes["encoder.dense.weight"] = (hidden, h * w * cin)
    shapes["encoder.dense.bias"] = (hidden,)
    for head in ("head_mu", "head_logvar"):
        shapes[f"encoder.{head}.weight"] = (zdim, hidden)
        shapes[f"encoder.{head}.bias"] = (zdim,)
    depth = len(dec_features)
    h0, w0, f0 = H // 2**depth, W // 2**depth, dec_features[0]
    shapes["decoder.dense.weight"] = (h0 * w0 * f0, zdim)
    shapes["decoder.dense.bias"] = (h0 * w0 * f0,)
    cin = f0
    for i, f in enumerate(dec_features):
        shapes[f"decoder.convs.{i}.weight"] = (f, cin, 3, 3)
        shapes[f"decoder.convs.{i}.bias"] = (f,)
        cin = f
    shapes["decoder.out.weight"] = (C, cin, 3, 3)
    shapes["decoder.out.bias"] = (C,)
    return shapes


def vae_flops(model: dict, image_shape) -> tuple[int, int]:
    """The forward FLOP of one image through the encoder and through the
    decoder (priced in its `dec_upsample` form), by yardstick/flops.py."""
    return (flops.encoder_fwd_flops(image_shape, model["enc_features"], model["zdim"]),
            flops.decoder_fwd_flops(image_shape, model["dec_features"], model["zdim"],
                                    model["dec_upsample"]))


def _same_pad(size: int) -> tuple[int, int]:
    total = max((_down(size) - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


def _dense(p, name, x, a: Arith):
    return F.linear(a.q(x), a.q(p[name + ".weight"]), a.cast(p[name + ".bias"]))


def _conv(p, name, x, a: Arith, stride: int, padding: int):
    return F.conv2d(a.q(x), a.q(p[name + ".weight"]), a.cast(p[name + ".bias"]),
                    stride=stride, padding=padding)


def encode(p: dict, y: torch.Tensor, a: Arith, n_convs: int):
    """(μ, log σ²) of NHWC images."""
    h = a.cast(y).permute(0, 3, 1, 2)
    for i in range(n_convs):
        (t, b), (l, r) = _same_pad(h.shape[2]), _same_pad(h.shape[3])
        h = F.elu(_conv(p, f"encoder.convs.{i}", F.pad(h, (l, r, t, b)), a, 2, 0))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.elu(_dense(p, "encoder.dense", h, a))
    return _dense(p, "encoder.head_mu", h, a), _dense(p, "encoder.head_logvar", h, a)


def decode(p: dict, z: torch.Tensor, a: Arith, image_shape, dec_features):
    """NHWC logits of latents z."""
    H, W, _ = image_shape
    depth = len(dec_features)
    h0, w0 = H // 2**depth, W // 2**depth
    h = F.elu(_dense(p, "decoder.dense", a.cast(z), a))
    h = h.reshape(z.shape[0], h0, w0, dec_features[0]).permute(0, 3, 1, 2)
    for i in range(depth):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = F.elu(_conv(p, f"decoder.convs.{i}", h, a, 1, 1))
    return _conv(p, "decoder.out", h, a, 1, 1).permute(0, 2, 3, 1)


# -- the GP

def _unit_rows(X: torch.Tensor) -> torch.Tensor:
    return X / torch.sqrt(torch.sum(X * X, dim=1, keepdim=True) + 1e-8)


def feature_rows(X, W, d, q) -> torch.Tensor:
    """V's rows x_d ⊗ w_q of unit-normalised object and view features."""
    Xn, Wn = _unit_rows(X), _unit_rows(W)
    return (Xn[d][:, :, None] * Wn[q][:, None, :]).reshape(d.shape[0], -1)


def variances(log_vs, log_vn):
    return torch.exp(log_vs), torch.exp(log_vn) + MIN_V_NOISE


def nll(Z, V, log_vs, log_vn) -> torch.Tensor:
    """½[L·log|K| + tr(Zᵀ K⁻¹ Z) + N·L·log 2π] by the Woodbury identity."""
    N, L = Z.shape
    vs, vn = variances(log_vs, log_vn)
    U = torch.sqrt(vs) * V
    R = U.shape[1]
    B = torch.eye(R, dtype=U.dtype, device=U.device) + U.T @ U / vn
    Lb = torch.linalg.cholesky(B)
    Wt = torch.linalg.solve_triangular(Lb, U.T @ Z, upper=False)
    logdet = N * torch.log(vn) + 2.0 * torch.sum(torch.log(torch.diagonal(Lb)))
    quad = (torch.sum(Z * Z) - torch.sum(Wt * Wt) / vn) / vn
    return 0.5 * (L * logdet + quad + N * L * math.log(2.0 * math.pi))


def taylor(Z0, V0, log_vs, log_vn) -> dict:
    """The NLL at (Z0, V0, θ) and its gradients in each, by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (Z0, V0, log_vs, log_vn)]
    with torch.enable_grad():
        value = nll(*leaves)
        grads = torch.autograd.grad(value, leaves)
    return {"value": value.detach(), **dict(zip(("dZ", "dV", "dlog_vs", "dlog_vn"), grads))}


def posterior_core(Z, V, log_vs, log_vn) -> torch.Tensor:
    """M = B⁻¹ UᵀZ / v_n, the (R, L) core of every prediction."""
    vs, vn = variances(log_vs, log_vn)
    U = torch.sqrt(vs) * V
    B = torch.eye(U.shape[1], dtype=U.dtype, device=U.device) + U.T @ U / vn
    return torch.linalg.solve(B, U.T @ Z) / vn


# -- the model around both

class GPPVAE:
    """One configuration's model over given parameters: `vae` by name,
    `gp` {'X', 'W', 'log_vs', 'log_vn'}, each a tensor on the card; the
    reference's own copies, in its dtype."""

    def __init__(self, cfg: dict, image_shape, vae: dict, gp: dict, precision: str = "exact"):
        self.a = Arith(precision)
        self.image_shape = tuple(image_shape)
        self.zdim = cfg["zdim"]
        self.enc, self.dec = tuple(cfg["enc_features"]), tuple(cfg["dec_features"])
        self.sigma_y, self.sat = cfg["sigma_y"], cfg["sat_penalty"]
        self.lr_vae, self.lr_gp, self.clip = cfg["lr_vae"], cfg["lr_gp"], cfg["clip_grad_norm"]
        dt = torch.float64 if precision == "exact" else torch.float32
        self.vae = {k: v.detach().to(dt).clone() for k, v in vae.items()}
        self.gp = {k: v.detach().to(dt).clone() for k, v in gp.items()}

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

    def rows(self, d, q):
        return feature_rows(self.gp["X"], self.gp["W"], d, q)

    def taylor(self, Z0, d, q) -> dict:
        """Phase B at the latents Z0 of the training rows (d, q)."""
        with self.a.scope():
            return taylor(self.a.cast(Z0), self.rows(d, q), self.gp["log_vs"], self.gp["log_vn"])

    def core(self, Z, d, q) -> torch.Tensor:
        with torch.no_grad(), self.a.scope():
            return posterior_core(self.a.cast(Z), self.rows(d, q), self.gp["log_vs"],
                                  self.gp["log_vn"])

    def predict(self, M, d, q, block: int = 256) -> torch.Tensor:
        """ŷ* of the cells (d, q) from the core M."""
        with torch.no_grad(), self.a.scope():
            vs, _ = variances(self.gp["log_vs"], self.gp["log_vn"])
            z = torch.sqrt(vs) * self.rows(d, q) @ M
        return self.images(z, block)

    def loss(self, coeffs, y, pos, w, eps, d, q, n_train: int, vae, gp):
        """One minibatch's loss at the parameters `vae`, `gp`."""
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

    def follow(self, coeffs, images_tr, d_tr, q_tr, steps, n_train: int,
               checked: int) -> dict:
        """Minibatch steps from this model's parameters, `steps` [(pos, w,
        eps)]. Returns the first `checked` steps' losses, the first step's
        gradients (after the clip, as Adam gets them) and each parameter's
        change after `checked` steps; the parameters move through every
        step."""
        vae = {k: v.clone().requires_grad_(True) for k, v in self.vae.items()}
        gp = {k: v.clone().requires_grad_(True) for k, v in self.gp.items()}
        names = [*vae, *(f"gp.{k}" for k in gp)]

        def now() -> dict:
            return dict(zip(names, [v.detach().clone() for v in (*vae.values(), *gp.values())]))

        start = now()
        adams = [Adam(list(vae.values()), self.lr_vae, self.clip),
                 Adam(list(gp.values()), self.lr_gp, self.clip)]
        losses, first, change = [], None, None
        with self.a.scope():
            for i, (pos, w, eps) in enumerate(steps):
                loss = self.loss(coeffs, images_tr[pos], pos, w, eps, d_tr[pos], q_tr[pos],
                                 n_train, vae, gp)
                grads = torch.autograd.grad(loss, [*vae.values(), *gp.values()])
                nv = len(vae)
                g_vae, g_gp = adams[0].step(grads[:nv]), adams[1].step(grads[nv:])
                if first is None:
                    first = dict(zip(names, [*g_vae, *g_gp]))
                if i < checked:
                    losses.append(float(loss.detach()))
                if i + 1 == checked:
                    change = {k: v - start[k] for k, v in now().items()}
        self.vae = {k: v.detach() for k, v in vae.items()}
        self.gp = {k: v.detach() for k, v in gp.items()}
        return {"losses": losses, "grads": first, "change": change}


class Adam:
    """Adam behind the global-norm clip, on a list of leaves."""

    def __init__(self, params, lr: float, clip: float):
        self.params, self.lr, self.clip, self.t = params, lr, clip, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        """Clip, update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if self.clip > 0 and norm >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        self.t += 1
        b1, b2 = 0.9, 0.999
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat, vhat = m / (1 - b1 ** self.t), v / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (torch.sqrt(vhat) + 1e-8))
        return grads
