"""Low-rank (Woodbury) GP prior over the latents: features, NLL, Taylor
surrogate and predictive posterior. Mirrors gppvae_tpu.gp."""

from gppvae_tpu_torch.gp.features import (
    OBJECT_KERNELS,
    build_effect_rows,
    build_V,
    fourier_view_features,
    kron_rows,
    make_rff_map,
    make_x_map,
    normalize_rows,
    polynomial_view_features,
    rff_draws,
)
from gppvae_tpu_torch.gp import dense
from gppvae_tpu_torch.gp.nystrom import nystrom_features, pivoted_cholesky_landmarks
from gppvae_tpu_torch.gp.taylor import (
    TaylorCoefficients,
    surrogate_batch_term,
    taylor_expand,
)
from gppvae_tpu_torch.gp.woodbury import (
    MIN_V_NOISE,
    GPFactors,
    PosteriorCore,
    extend_posterior_core,
    factorize,
    gp_nll_from_features,
    kinv_z_core,
    posterior_core,
    predict_cov_from_core,
    predict_from_core,
    predict_latents,
    scaled_features,
    variances_from_log,
)

__all__ = [
    "GPFactors", "MIN_V_NOISE", "OBJECT_KERNELS",
    "PosteriorCore", "TaylorCoefficients", "build_V", "build_effect_rows",
    "dense", "extend_posterior_core", "factorize", "fourier_view_features", "gp_nll_from_features",
    "kinv_z_core", "kron_rows", "make_rff_map", "make_x_map",
    "normalize_rows", "nystrom_features", "pivoted_cholesky_landmarks",
    "polynomial_view_features", "posterior_core", "predict_cov_from_core",
    "predict_from_core",
    "predict_latents", "rff_draws", "scaled_features",
    "surrogate_batch_term", "taylor_expand", "variances_from_log",
]
