"""GPPVAE training driver ('joint' and 'dis').

Counterpart of gppvae_tpu/train/train_gppvae.py, in the order of its
phase-per-dispatch path (`_run_profiled`), one epoch at a time:

  Phase A  grad-free encode of every training row → Z₀ (N×L latent means)
  Phase B  the exact Woodbury NLL at (Z₀, V₀) and its Taylor coefficients by
           autodiff (gp.taylor_expand); this launches both CUDA kernels
           (ops.factor_prep → ops.woodbury_nll_core) and their backwards
  Phase C  minibatch steps on the surrogate: encode → sample → decode with
           gradients, the GP surrogate term and the entropy term; one
           guarded Adam for the VAE and one for the GP parameters, each
           stepping every grad_accum_steps minibatches; with
           refresh_every_steps = k, Phase A+B re-run at the current
           parameters after every k steps. In one process on a CUDA device
           with an Adam step every minibatch, the step is captured once as a
           CUDA graph and replayed (`_GraphStep`)
  Eval     a fresh encode, GP-predictive latents for the held-out cells,
           decoded; pixel MSE → oos_mse

With compute_dtype='bfloat16' the VAE computes in bfloat16 (params and the
whole GP path stay float32); the last polish_epochs epochs run in float32
on the same parameters, and both Adams restart at the switch.

    python -m gppvae_tpu_torch.train.train_gppvae --data synthetic \
        --mode joint --vae_weights out/vae/vae_weights.pt --device cuda

Every random draw is the JAX trainer's at the same --seed (utils/prng.py):
split(PRNGKey(seed), 4) gives the run key, the VAE's init key (flax's
init, models/vae.py), a sample key and the key of X₀; epoch e's plan and ε
come from fold_in(run key, e) (train/batching.py), the panels' ε from
fold_in(epoch key, 2). `train_gppvae` also takes injected initial params
(with the RFF draws and Nyström landmarks) and a `draws(epoch)` callable,
so that a test can feed it draws of its own. `outdir` receives
config.json (the config and the
dataset it ran on), metrics.jsonl and final_params.pt, which `load_final`
reads back; panel_NNNN.png every panel_every epochs; and the whole train
state (`_train_state`) as state_NNNN every checkpoint_every epochs and as
final_state at the end, either of which `resume` continues from: the
interrupted and resumed run equals the uninterrupted one epoch by epoch.
`profile_dir` wraps the epochs in a torch.profiler trace.

With `group` (a parallel.DataGroup, one per rank of `world` processes) the
run is data-parallel, as the JAX trainer runs under a 1-D mesh: the training
rows are padded by wrap-around to a multiple of the world size (weight-0
rows, zeroed after Phase A) and each rank holds its contiguous block;
parameters, optimizer states and the random stream are the same on every
rank. Phase A encodes the rank's rows; Phase B reduces the R-sized sums of
the NLL (ops.factor_prep) and the Taylor coefficients' parameter part
(gp.taylor_expand); in Phase C each rank computes the batch rows that lie in
its block ("owner computes": no image crosses ranks) and one all-reduce sums
the gradients of both Adams' parameters with the step's metric sums, so the
guarded Adams decide alike everywhere; eval reduces the posterior core. The
result equals the single-process run up to the order of the sums. Each
epoch's record adds the rank's collective calls and bytes, and after each
epoch the parameters are checked bit-equal across ranks. Rank 0 alone writes
the artifacts and logs; a state written by either run resumes in the other.

With a parallel.MeshGroup (a rank of a data × model mesh, as the JAX
trainer runs under make_mesh_2d) the rows split over the data axis as
above, and after the parameters are replicated the large conv and dense
weights split by output features over the model axis (`split_model_axis`,
parallel/tensor.py; the VAE runs those layers column-parallel). Every
R-sized sum and the gradient all-reduce go over the data axis only: a
block's gradient is whole for its columns, and the replicated gradients are
made alike on the model row by one broadcast; the guarded Adams' Σg² sums
the blocks' part over the model axis. The replicated parameters are checked
over the world, the blocks over the data axis. Checkpoints, final_state,
final_params.pt and the result hold the full weights, gathered, so a mesh
run is read, generated from, served and resumed like any other, and a
resume on a mesh splits them again.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import os
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from gppvae_tpu_torch import gp
from gppvae_tpu_torch.checkpoint import CheckpointFormatError, load_tree, save_tree
from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.convert import gp_params_from_numpy
from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.eval.oos import predict_heldout
from gppvae_tpu_torch.eval.panels import save_panel
from gppvae_tpu_torch.models import (
    ARCH_DEFAULTS,
    VAE,
    add_arch_flags,
    arch_from_flags,
    encode_all,
    sample_reconstruction,
    vae_from_record,
)
from gppvae_tpu_torch.parallel import (
    all_reduce_grads,
    check_replicated,
    padded_rows,
    replicate,
    row_block,
    summary,
)
from gppvae_tpu_torch.parallel import tensor as tp
from gppvae_tpu_torch.parallel.tensor import split_model_axis
from gppvae_tpu_torch.train.batching import make_draws, masked_means, num_batches
from gppvae_tpu_torch.train.device import PhaseTimer, resolve_device, set_float32_precision
from gppvae_tpu_torch.train.losses import (
    gaussian_recon_nll,
    logit_saturation_penalty,
    neg_entropy,
)
from gppvae_tpu_torch.train.optim import GuardedAdam, resolve_grad_accum
from gppvae_tpu_torch.utils import MetricsLogger, NullLogger, prng
from gppvae_tpu_torch.utils.profiling import maybe_trace
from gppvae_tpu_torch.utils.timers import count, read, span, tally

_METRIC_KEYS = (
    "loss", "recon_term", "gp_term", "pen_term", "mse",
    "gp_nll_full", "v_sig", "v_noise", "oos_mse",
)
FINAL_PARAMS_FILE = "final_params.pt"
FINAL_STATE_FILE = "final_state"
# the config fields that shape a tensor of the train state: a resume under
# another value of one of them is refused by name
_SHAPE_FIELDS = (
    "mode", "zdim", "enc_features", "dec_features", "obj_feature_dim", "view_num_freqs",
    "view_feature_dim", "object_kernel", "rff_features", "nystrom_rank", "extra_effects",
    "learn_sigma_y", "vae_layout",
)
# what a state written before one of _SHAPE_FIELDS existed was written under
_SHAPE_DEFAULTS = {"vae_layout": ARCH_DEFAULTS["vae_layout"]}


@dataclasses.dataclass(frozen=True)
class GPPVAETrainConfig:
    mode: str = "joint"  # 'joint' | 'dis'
    zdim: int = ARCH_DEFAULTS["zdim"]
    epochs: int = 100
    batch_size: int = 128
    lr_vae: float = 2e-4
    lr_gp: float = 1e-3
    seed: int = 0
    sigma_y: float = 0.1
    learn_sigma_y: bool = False
    obj_feature_dim: int = 8  # object rank M
    view_num_freqs: int = 3  # Fourier view features → M_w = 2f + 1
    view_feature_dim: int | None = None
    object_kernel: str = "linear"  # 'linear' | 'rbf' | 'rbf-nystrom'
    rff_features: int = 32  # RFF rank of the rbf object kernels
    rff_lengthscale: float = 1.0
    nystrom_rank: int = 16  # landmark objects of 'rbf-nystrom'
    extra_effects: tuple = ()  # of 'object', 'view'
    init_v_sig: float = 1.0
    init_v_noise: float = 0.5
    enc_features: Sequence[int] = ARCH_DEFAULTS["enc_features"]
    dec_features: Sequence[int] = ARCH_DEFAULTS["dec_features"]
    compute_dtype: str = ARCH_DEFAULTS["compute_dtype"]  # VAE compute
    dec_upsample: str = ARCH_DEFAULTS["dec_upsample"]  # same params either way: models/vae.py
    vae_layout: str = ARCH_DEFAULTS["vae_layout"]
    polish_epochs: int = 0  # bfloat16 runs: the last K epochs in float32
    clip_grad_norm: float = 1e5  # global-norm clip in front of Adam (<=0 off)
    sat_penalty: float = 1.0  # saturation-death barrier weight (<=0 off)
    grad_accum_steps: int = 1  # Adam step every k minibatches; -1 = auto
    refresh_every_steps: int = 0  # Phase A+B every k steps (0 = per epoch)
    vae_weights: str | None = None  # train_vae's vae_weights.pt
    resume: str | None = None  # a state_NNNN / final_state to continue from
    profile_dir: str | None = None  # torch.profiler trace of the epochs
    encode_chunk: int = 1024  # Phase-A chunk (activation footprint cap)
    outdir: str | None = None
    panel_every: int = 0  # epochs between image panels (0 = off)
    checkpoint_every: int = 0  # epochs between state_NNNN (0 = end only)
    data: str | None = None  # the CLI --data flag, recorded in config.json


@dataclasses.dataclass
class GPPVAETrainResult:
    model: VAE
    gp_params: dict  # {'X', 'W' (joint), 'log_vs', 'log_vn', 'log_sy' (learn_sigma_y)}
    fixed_W: torch.Tensor | None  # the fixed view features in 'dis' mode
    config: GPPVAETrainConfig
    history: list[dict]
    data: dict  # the tensors trained on, on the device: images_tr, d_tr, q_tr, *_ho
    # (with a group: the rank's block of the padded training rows, and row_mask)
    x_map: Callable | None = None  # the object-kernel feature map (gp.make_x_map)
    optimizers: dict | None = None  # {'vae', 'gp'}: the GuardedAdams at the end


_RANDOM_W_KEY = 7  # the JAX trainer's PRNGKey(7) for the same fallback
# what a train state's `stream` names: the draws depend on the seed and the
# epoch alone (train/batching.py), so a state carries no generator
STREAM = "threefry2x32"


def run_keys(seed: int):
    """(run, init, sample, x) = split(PRNGKey(seed), 4), train_gppvae.py:632-633."""
    return tuple(prng.split(prng.PRNGKey(seed), 4))


def _init_view_features(config: GPPVAETrainConfig, dataset: GridDataset) -> torch.Tensor:
    """Fixed view features (Q, M_w) float32 from the view auxiliary:
    Fourier features of rotation angles, polynomial features of a linear
    axis, else random unit rows: the JAX trainer's normal(PRNGKey(7)) rows
    (train_gppvae.py:229), the same at every config.seed."""
    aux = dataset.view_aux
    if aux.shape[1] == 1 and dataset.periodic_views:
        freqs = config.view_num_freqs
        if config.view_feature_dim is not None:
            if config.view_feature_dim < 3 or config.view_feature_dim % 2 == 0:
                raise ValueError(
                    "view_feature_dim must be odd ≥ 3 for periodic view aux "
                    f"(got {config.view_feature_dim}); Fourier rank is 1+2f"
                )
            freqs = (config.view_feature_dim - 1) // 2
        angles = torch.from_numpy(np.asarray(aux[:, 0], np.float32))
        return gp.fourier_view_features(angles, num_freqs=freqs)
    if aux.shape[1] == 1:
        degree = (config.view_feature_dim or (2 * config.view_num_freqs + 1)) - 1
        pos = torch.from_numpy(np.asarray(aux[:, 0], np.float32))
        return gp.polynomial_view_features(pos, degree=degree)
    Mw = config.view_feature_dim or (2 * config.view_num_freqs + 1)
    return gp.normalize_rows(torch.from_numpy(
        prng.normal(prng.PRNGKey(_RANDOM_W_KEY), (dataset.num_views, Mw))))


def _data_tensors(dataset: GridDataset, device: torch.device, group=None) -> dict:
    """The train and held-out rows as tensors on the device, and the first 8
    training images (a panel's). With a group: the rank's block of the
    training rows padded to a multiple of the world size, and their 0/1
    `row_mask`; the held-out rows whole."""
    def rows(idx):
        return torch.from_numpy(np.asarray(idx, np.int64)).to(device)

    tr, ho = dataset.train_idx, dataset.heldout_idx
    out = {"images_panel": torch.from_numpy(dataset.images[tr[:8]]).to(device)}
    if group is not None:
        pos, weights = padded_rows(len(tr), group.world)
        block = row_block(len(pos), group)
        tr = tr[pos[block]]
        out["row_mask"] = torch.from_numpy(weights[block]).to(device)
    return {
        **out,
        "images_tr": torch.from_numpy(dataset.images[tr]).to(device),
        "d_tr": rows(dataset.object_ids[tr]),
        "q_tr": rows(dataset.view_ids[tr]),
        "y_ho": torch.from_numpy(dataset.images[ho]).to(device),
        "d_ho": rows(dataset.object_ids[ho]),
        "q_ho": rows(dataset.view_ids[ho]),
    }


def _setup(dataset: GridDataset, config: GPPVAETrainConfig, device: torch.device,
           init_params: dict | None = None, group=None):
    """(model, gp_params, fixed_W, data, num_train), the fresh ones drawn
    from config.seed's keys (`run_keys`). init_params may give
    {'vae': state_dict, 'gp': {name: array}}, each replacing the fresh
    init (and --vae_weights). With a group, the parameters are rank 0's on
    every rank and the data the rank's rows; on a mesh with a model axis the
    large weights then split over it (split_model_axis)."""
    init_params = init_params or {}
    _, init_key, _, x_key = run_keys(config.seed)
    with span("setup.model"):
        model = vae_from_record(vars(config), dataset.image_shape, key=init_key)
        if "vae" in init_params:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params["vae"].items()})
        elif config.vae_weights:
            try:
                model.load_state_dict(torch.load(config.vae_weights, map_location="cpu",
                                                 weights_only=True))
            except RuntimeError as e:
                raise ValueError(
                    f"--vae_weights {config.vae_weights!r} does not fit the "
                    f"{config.vae_layout!r} vae_layout: pretrain with the same --vae_layout "
                    f"({e})") from e
        model.to(device)

    with span("setup.gp"):
        W0 = _init_view_features(config, dataset)
        M = config.obj_feature_dim
        gp_init = {
            "X": torch.from_numpy(prng.normal(x_key, (dataset.num_objects, M))) / math.sqrt(M),
            # one signal variance per random effect
            "log_vs": torch.full((1 + len(config.extra_effects),), math.log(config.init_v_sig)),
            "log_vn": torch.tensor(math.log(config.init_v_noise)),
        }
        if config.learn_sigma_y:
            gp_init["log_sy"] = torch.tensor(math.log(config.sigma_y))
        fixed_W = None
        if config.mode == "joint":
            gp_init["W"] = W0
        else:
            fixed_W = W0.to(device)
        for k, v in gp_params_from_numpy(init_params.get("gp", {})).items():
            if k not in gp_init:
                raise KeyError(f"unknown GP param {k!r} for mode {config.mode!r}")
            gp_init[k] = v
        gp_params = {k: torch.nn.Parameter(v.to(device=device, dtype=torch.float32))
                     for k, v in gp_init.items()}
        replicate(group, [*model.parameters(), *gp_params.values()])
        split_model_axis(model, group)
    with span("setup.data"):
        data = _data_tensors(dataset, device, group)
    return model, gp_params, fixed_W, data, len(dataset.train_idx)


def _select_nystrom_landmarks(X0: torch.Tensor, draws, config: GPPVAETrainConfig) -> np.ndarray:
    """nystrom_rank landmark objects by greedy pivoted Cholesky on the
    RFF-mapped initial object features, on the host, once; padded with
    unused rows to exactly nystrom_rank (train_gppvae.py:354-369)."""
    rff, _ = gp.make_rff_map(draws, config.rff_lengthscale)
    with torch.no_grad():
        F0 = rff(gp.normalize_rows(X0.float())).cpu().numpy()
    m = min(config.nystrom_rank, len(F0))
    idx = gp.pivoted_cholesky_landmarks(F0, m, tol=0.0)
    if len(idx) < m:
        rest = np.setdiff1d(np.arange(len(F0), dtype=np.int32), idx)
        idx = np.concatenate([idx, rest[: m - len(idx)]]).astype(np.int32)
    return idx


def _object_kernel(config: GPPVAETrainConfig, X0: torch.Tensor, init_params: dict,
                   device: torch.device):
    """(x_map, draws) of config.object_kernel: the feature map and the
    {'omega', 'phase', 'nystrom_idx'} it was built from (None for 'linear').
    init_params may give 'rff' = (Ω, b) and 'nystrom_idx'; otherwise Ω, b
    come from gp.rff_draws(seed) and the landmarks from X0."""
    if config.object_kernel == "linear":
        return None, None
    if "rff" in init_params:
        omega, phase = (torch.as_tensor(np.asarray(a), dtype=torch.float32)
                        for a in init_params["rff"])
    else:
        omega, phase = gp.rff_draws(config.obj_feature_dim, config.rff_features, config.seed)
    if tuple(omega.shape) != (config.obj_feature_dim, config.rff_features):
        raise ValueError(f"RFF draws Ω of shape {tuple(omega.shape)}; want "
                         f"(obj_feature_dim, rff_features) = "
                         f"({config.obj_feature_dim}, {config.rff_features})")
    draws = {"omega": omega.to(device), "phase": phase.to(device), "nystrom_idx": None}
    if config.object_kernel == "rbf-nystrom":
        idx = init_params.get("nystrom_idx")
        if idx is None:
            idx = _select_nystrom_landmarks(X0, (omega, phase), config)
        draws["nystrom_idx"] = torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(device)
    return _x_map(config, draws), draws


def _x_map(config: GPPVAETrainConfig, draws: dict):
    return gp.make_x_map(config.object_kernel, (draws["omega"], draws["phase"]),
                         config.rff_lengthscale, draws["nystrom_idx"])


def _polish_epochs(config: GPPVAETrainConfig) -> int:
    """The float32 tail of a bfloat16 run (0 for float32 runs)."""
    if config.polish_epochs > 0 and config.compute_dtype == "bfloat16":
        return min(config.polish_epochs, config.epochs)
    return 0


def graph_steps(device: torch.device, group, accum_steps: int) -> bool:
    """Whether Phase C's steps run as a CUDA graph: in one process on a CUDA
    device, with an Adam step every call (an accumulating step branches on
    the host, a group's step all-reduces)."""
    return device.type == "cuda" and group is None and accum_steps == 1


WARMUP_STEPS = 2  # eager steps on the capture stream before each capture
# what torch.optim warns of a capturable Adam's eager steps (the warm-ups)
_UNCAPTURED = "This instance was constructed with capturable=True"


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream Phase C's graphs are captured on, one per device, so
    that what the warm-ups make per stream (cuBLAS's workspace, conv3x3's
    scratch) serves every capture."""
    return torch.cuda.Stream(device)


def _coeff_tensors(c: gp.TaylorCoefficients) -> list[torch.Tensor]:
    dV = c.dV if isinstance(c.dV, list) else [c.dV]
    return [c.value, c.dZ, *dV, *(c.daux[k] for k in sorted(c.daux))]


def _coeff_layout(c: gp.TaylorCoefficients) -> tuple:
    return (isinstance(c.dV, list), tuple(sorted(c.daux)),
            tuple((t.shape, t.dtype) for t in _coeff_tensors(c)))


class _GraphStep:
    """One Phase C step as a CUDA graph over static buffers.

    Each call copies the step's (pos, w, eps) into the static inputs, and
    Taylor coefficients other than those last copied into the static ones.
    The first WARMUP_STEPS calls run the eager step on the capture stream
    (Adam's state, conv3x3's plans and that stream's scratch are made
    there); the next captures it, and it and every later call replay the
    graph and return a copy of its (5,) metrics. What the captured step
    counted on the host (the tracer's counts, each guarded Adam's calls)
    is credited again on each replay. A graph serves the owners (both
    optimizers, their states, the config) and the layout (the inputs'
    shapes and dtypes, the compute dtype, the coefficients') it was
    captured with (`fits`)."""

    def __init__(self, owners: tuple, layout: tuple, coeffs, inputs, opts):
        self.owners, self.layout, self.opts = owners, layout, opts
        self.coeffs = gp.TaylorCoefficients(
            torch.empty_like(coeffs.value), torch.empty_like(coeffs.dZ),
            [torch.empty_like(v) for v in coeffs.dV] if isinstance(coeffs.dV, list)
            else torch.empty_like(coeffs.dV),
            {k: torch.empty_like(v) for k, v in coeffs.daux.items()})
        self.inputs = [torch.empty_like(t) for t in inputs]
        self.source = None  # the coefficients last copied in
        self.stream = _capture_stream(inputs[0].device)
        self.warm = 0
        self.graph = self.metrics = None
        self.tallies: dict = {}
        self.guarded: list[int] = []

    def fits(self, owners: tuple, layout: tuple) -> bool:
        return self.layout == layout and all(a is b for a, b in zip(self.owners, owners))

    def load(self, coeffs, inputs) -> None:
        if coeffs is not self.source:
            torch._foreach_copy_(_coeff_tensors(self.coeffs), _coeff_tensors(coeffs))
            self.source = coeffs
        torch._foreach_copy_(self.inputs, list(inputs))

    def __call__(self, step: Callable) -> torch.Tensor:
        if self.warm < WARMUP_STEPS:
            self.warm += 1
            here = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream), warnings.catch_warnings():
                warnings.filterwarnings("ignore", _UNCAPTURED)
                metrics = step(self.coeffs, *self.inputs)
            here.wait_stream(self.stream)
            return metrics
        if self.graph is None:
            self._capture(step)
        with span("C.replay"):
            self.graph.replay()
            count("C.graph_replay")
            for name, n in self.tallies.items():
                count(name, n)
            for opt, n in zip(self.opts, self.guarded):
                opt.guarded += n
            return self.metrics.clone()

    def _capture(self, step: Callable) -> None:
        before = [opt.guarded for opt in self.opts]
        for opt in self.opts:
            opt.zero_grad()
        graph = torch.cuda.CUDAGraph()
        with tally() as self.tallies, torch.cuda.graph(graph, stream=self.stream):
            self.metrics = step(self.coeffs, *self.inputs)
        self.guarded = [opt.guarded - b for opt, b in zip(self.opts, before)]
        for opt, b in zip(self.opts, before):
            opt.guarded = b
        self.graph = graph
        count("C.graph_capture")


class _Loop:
    """The epoch's building blocks over one model, its GP params and data.
    With a group, `data` holds the rank's block of the padded training rows
    (`_data_tensors`) and num_train is the whole training set's size."""

    def __init__(self, model: VAE, gp_params: dict, fixed_W, data: dict,
                 num_train: int, config: GPPVAETrainConfig, *, x_map=None,
                 accum_steps: int = 1, group=None):
        self.model, self.gp, self.fixed_W = model, gp_params, fixed_W
        self.data, self.num_train, self.config = data, num_train, config
        self.x_map, self.accum_steps, self.group = x_map, accum_steps, group
        if group is not None:  # the global positions of the rank's rows
            self.block = row_block(data["images_tr"].shape[0] * group.world, group)
        if config.batch_size > num_train:
            raise ValueError(f"batch_size {config.batch_size} exceeds train set {num_train}")
        self.nb = num_batches(num_train, config.batch_size)
        self.chunk = min(config.encode_chunk, num_train)
        self.graphs = graph_steps(data["images_tr"].device, group, accum_steps)
        self.graph: _GraphStep | None = None
        with torch.no_grad():  # rejects an unknown extra effect before any work
            self.build_effects(gp_params["X"], self.view_W(), data["d_tr"][:1],
                               data["q_tr"][:1])
        self.restart_optimizers()

    def restart_optimizers(self) -> None:
        """Fresh guarded Adams (moments, step counts and accumulators)."""
        config = self.config
        params = list(self.model.parameters())
        self.shards = tp.shard_mask(self.model, params)
        self.opt_vae = GuardedAdam(params, config.lr_vae, config.clip_grad_norm,
                                   self.accum_steps, shards=(self.group, self.shards),
                                   capturable=self.graphs)
        self.opt_gp = GuardedAdam([self.gp[k] for k in sorted(self.gp)], config.lr_gp,
                                  config.clip_grad_norm, self.accum_steps,
                                  capturable=self.graphs)

    def view_W(self):
        return self.gp["W"] if self.config.mode == "joint" else self.fixed_W

    def aux(self) -> dict:
        return {"log_vs": self.gp["log_vs"], "log_vn": self.gp["log_vn"]}

    def build_effects(self, X, W, d, q) -> list[torch.Tensor]:
        return gp.build_effect_rows(X, W, d, q, extra_effects=self.config.extra_effects,
                                    x_map=self.x_map)

    def nll_fn(self, Z, Vs, aux):
        v_sig, v_noise = gp.variances_from_log(aux["log_vs"], aux["log_vn"])
        return gp.gp_nll_from_features(
            Z, Vs, [v_sig[i] for i in range(len(Vs))], v_noise,
            num_rows=self.num_train, group=self.group,
        )

    # -- Phase A
    def encode(self) -> torch.Tensor:
        return encode_all(self.model, self.data["images_tr"], self.chunk)

    # -- Phase B
    def solve(self, Z0: torch.Tensor) -> gp.TaylorCoefficients:
        d = self.data
        with torch.no_grad():
            V0 = self.build_effects(self.gp["X"], self.view_W(), d["d_tr"], d["q_tr"])
            if self.group is not None:
                # the rows that pad the split: zero, so they add nothing to
                # any sum (train_gppvae.py:420-433's _mask_rows)
                mask = d["row_mask"][:, None]
                Z0, V0 = Z0 * mask, [v * mask for v in V0]
        return gp.taylor_expand(self.nll_fn, Z0, V0,
                                {k: v.detach() for k, v in self.aux().items()},
                                group=self.group)

    # -- Phase C
    def batch_terms(self, coeffs, pos, w, eps):
        """The loss of the batch rows `pos` and their per-row recon, pen and
        mse; gp_term per bs."""
        config, d, bs = self.config, self.data, self.config.batch_size
        sy = torch.exp(self.gp["log_sy"]) if config.learn_sigma_y else config.sigma_y
        y = d["images_tr"][pos]
        mu, logvar = self.model.encode(y)
        z = mu + torch.exp(0.5 * logvar) * eps
        logits = self.model.decode(z)
        recon, mse = gaussian_recon_nll(y, torch.sigmoid(logits), sy)
        if config.sat_penalty > 0:
            recon = recon + config.sat_penalty * logit_saturation_penalty(logits)
        v = self.build_effects(self.gp["X"], self.view_W(), d["d_tr"][pos], d["q_tr"][pos])
        gp_term = gp.surrogate_batch_term(
            coeffs, pos, z, v, self.aux(), self.num_train, weights=w) / bs
        pen_rows = neg_entropy(logvar)
        # sum over VALID rows / constant bs (batching.py convention)
        loss = (torch.sum(w * recon) + torch.sum(w * pen_rows)) / bs + gp_term
        return loss, recon, gp_term, pen_rows, mse

    def minibatch_step(self, coeffs, pos, w, eps) -> torch.Tensor:
        """One guarded-Adam call on both groups; returns the (5,) metrics
        [loss, recon, gp_term, pen, mse] (masked means; gp_term per bs).

        With a group, pos / w / eps are the batch rows this rank owns (pos
        local to its block; there may be none): its share of the loss is
        differentiated, and one all-reduce sums the gradients of both Adams'
        parameters with the metric sums, so that both Adams see the whole
        batch's gradient on every rank.

        Where `graph_steps` holds, the step runs as a CUDA graph
        (`_GraphStep`), captured anew when the inputs' shapes or dtypes, the
        coefficients' layout, the compute dtype, an optimizer or its state,
        or the config change."""
        with span("C.step"):
            if not self.graphs:
                return self._step(coeffs, pos, w, eps)
            inputs = (pos, w, eps)
            owners = (self.opt_vae, self.opt_vae.adam.state, self.opt_gp,
                      self.opt_gp.adam.state, self.config)
            layout = (*((t.shape, t.dtype) for t in inputs), self.model.dtype,
                      _coeff_layout(coeffs))
            if self.graph is None or not self.graph.fits(owners, layout):
                self.graph = None  # the old graph's memory goes first
                self.graph = _GraphStep(owners, layout, coeffs, inputs,
                                        (self.opt_vae, self.opt_gp))
            self.graph.load(coeffs, inputs)
            return self.graph(self._step)

    def _step(self, coeffs, pos, w, eps) -> torch.Tensor:
        """The step's work, eager: what minibatch_step runs or captures."""
        self.opt_vae.zero_grad()
        self.opt_gp.zero_grad()
        if self.group is None:
            with span("C.forward"):
                loss, recon, gp_term, pen_rows, mse = self.batch_terms(coeffs, pos, w, eps)
                recon_m, pen_m, mse_m = masked_means(w, recon, pen_rows, mse)
                metrics = torch.stack([loss, recon_m, gp_term, pen_m, mse_m]).detach()
            with span("C.backward"):
                loss.backward()
        else:
            # loss, Σw·recon, gp_term, Σw·pen, Σw·mse, Σw
            sums = torch.zeros(6, device=w.device)
            if pos.numel():
                with span("C.forward"):
                    loss, recon, gp_term, pen_rows, mse = self.batch_terms(
                        coeffs, pos, w, eps)
                with span("C.backward"):
                    loss.backward()
                sums = torch.stack([loss, torch.sum(w * recon), gp_term,
                                    torch.sum(w * pen_rows), torch.sum(w * mse),
                                    torch.sum(w)]).detach()
            sums = all_reduce_grads(self.group, [*self.opt_vae.params, *self.opt_gp.params],
                                    sums, [*self.shards, *[False] * len(self.opt_gp.params)])
            metrics = sums[:5].clone()
            metrics[[1, 3, 4]] /= sums[5]  # the masked means
        with span("C.optim"):
            self.opt_vae.step()
            self.opt_gp.step()
        return metrics

    def epoch_steps(self, batches, weights, eps) -> list[tuple]:
        """The epoch's (pos, w, eps) per step on the device, from the plan's
        host tensors: each whole batch, or with a group the rows of it whose
        position lies in this rank's block ("owner computes": no image
        crosses ranks), pos local to the block."""
        device = self.data["images_tr"].device
        if self.group is None:  # blocking copies from host memory: the host waits
            b, w, e = (read("plan", lambda t: t.to(device), t) for t in (batches, weights, eps))
            return [(b[i], w[i], e[i]) for i in range(b.shape[0])]
        start, stop = self.block.start, self.block.stop
        own = (batches >= start) & (batches < stop)
        counts = own.sum(dim=1).tolist()
        return list(zip((batches[own] - start).to(device).split(counts),
                        weights[own].to(device).split(counts),
                        eps[own].to(device).split(counts)))

    def minibatch_epoch(self, coeffs, steps: list[tuple]) -> torch.Tensor:
        """All steps of one plan (`epoch_steps`); the (5,) metrics averaged
        over steps. With refresh_every_steps = k < nb, Phase A+B re-run at
        the current params before each segment of k steps but the first,
        which uses `coeffs`."""
        nb, k = len(steps), self.config.refresh_every_steps
        seg = k if 0 < k < nb else nb
        rows = []
        for s in range(0, nb, seg):
            if s > 0:
                coeffs = self.solve(self.encode())
            rows += [self.minibatch_step(coeffs, *steps[b]) for b in range(s, min(s + seg, nb))]
        return torch.stack(rows).mean(dim=0)

    # -- eval
    def oos(self, Z: torch.Tensor):
        d = self.data
        return predict_heldout(self.model, self.gp, self.fixed_W, Z, d["d_tr"],
                               d["q_tr"], d["d_ho"], d["q_ho"], d["y_ho"],
                               x_map=self.x_map, extra_effects=self.config.extra_effects,
                               row_weights=d.get("row_mask"), group=self.group)

    def run_epoch(self, draws: Callable, epoch: int) -> tuple[dict, dict, torch.Tensor]:
        """One epoch: Phase A, B, C, then eval, each timed to a device sync.
        Returns ({_METRIC_KEYS: float}, {phase: seconds}, the held-out
        predictions ŷ)."""
        device = self.data["images_tr"].device
        timer = PhaseTimer(device)
        with timer.phase("A_encode"):
            Z0 = self.encode()
        with timer.phase("B_solve"):
            coeffs = self.solve(Z0)
        with timer.phase("C_minibatch"):
            cm = self.minibatch_epoch(coeffs, self.epoch_steps(*draws(epoch)))
        with timer.phase("eval_oos"):
            y_pred, oos_mse = self.oos(self.encode())
        row = [*read("metrics", torch.Tensor.tolist, cm),
               read("nll", float, coeffs.value) / self.num_train,
               math.exp(read("v_sig", float, self.gp["log_vs"][0].detach())),  # product effect
               math.exp(read("v_noise", float, self.gp["log_vn"].detach())),
               read("oos_mse", float, oos_mse)]
        return dict(zip(_METRIC_KEYS, row)), timer.reset(), y_pred


def _write_sidecar(config: GPPVAETrainConfig, dataset: GridDataset, device) -> None:
    """config.json: the config, the dataset it ran on (so that an
    evaluation rebuilds the same grid) and the device."""
    os.makedirs(config.outdir, exist_ok=True)
    with open(os.path.join(config.outdir, "config.json"), "w") as f:
        json.dump({
            **dataclasses.asdict(config),
            "dataset": {
                "name": dataset.name,
                "num_objects": dataset.num_objects,
                "num_views": dataset.num_views,
                "image_size": int(dataset.image_shape[0]),
            },
            "device": str(device),
        }, f, indent=1, default=list)


def _shape_config(config: GPPVAETrainConfig, dataset: GridDataset) -> dict:
    """The values a train state's tensors were shaped by."""
    shape = {k: getattr(config, k) for k in _SHAPE_FIELDS}
    shape = {k: list(v) if isinstance(v, (tuple, list)) else v for k, v in shape.items()}
    return {**shape, "num_objects": dataset.num_objects, "num_views": dataset.num_views,
            "image_shape": list(dataset.image_shape)}


def _train_state(loop: _Loop, x_draws: dict | None, epoch: int, shape: dict) -> dict:
    """Everything the next epoch reads, `epoch` epochs done: the VAE, the GP
    params, both guarded Adams whole, the 'dis' mode's fixed W and the
    object-kernel draws and landmarks (the run's own, never re-drawn). The
    epochs' draws follow from the seed and the epoch; `stream` names them.
    Whole under tensor parallelism (every rank calls it: the blocks are
    gathered over the model axis)."""
    return {
        "vae": tp.gather_state_dict(loop.model),
        "gp": dict(loop.gp),
        "opt_vae": loop.opt_vae.state_dict(),
        "opt_gp": loop.opt_gp.state_dict(),
        "fixed_W": loop.fixed_W,
        "object_kernel": x_draws,
        "stream": STREAM,
        "epoch": epoch,
        "shape": shape,
    }


def _load_resume(path: str, shape: dict, device: torch.device) -> dict:
    """The train state at `path` (format checked by load_tree), refused by
    field name if it was written under a config of other shapes, and
    refused if its run drew from the torch.Generator stream the port had
    before it drew the JAX package's: that run cannot continue as it
    began."""
    state = load_tree(path, map_location=device)
    if not isinstance(state, dict) or not {"shape", "opt_vae"} <= set(state):
        raise CheckpointFormatError(
            f"{path!r} is a tree of this format but not a train state of train_gppvae "
            "(a state_NNNN or final_state)")
    if state.get("stream") != STREAM:
        raise ValueError(
            f"resume {path!r}: its run drew its plans and ε from a torch.Generator "
            f"(its 'generator' field), not from the {STREAM} stream of the seed; it "
            "would continue on other draws than it began with. Train it again")
    saved = {k: state["shape"].get(k, _SHAPE_DEFAULTS.get(k)) for k in shape}
    differs = [f"{k}: the state has {saved[k]!r}, this run {v!r}"
               for k, v in shape.items() if saved[k] != v]
    if differs:
        raise ValueError(f"resume {path!r} was written under another configuration ("
                         + "; ".join(differs) + ")")
    return state


def _panel(loop: _Loop, y_pred: torch.Tensor, key) -> list:
    """panel_NNNN.png's rows: 8 training images, their reconstructions
    (ε from `key`), 8 held-out images, their predictions
    (train_gppvae.py:979-991). Every rank computes them: a split layer's
    forward is collective."""
    d = loop.data
    y = d["images_panel"]
    recon = sample_reconstruction(loop.model, y, key)
    return [t.cpu().numpy() for t in (y, recon, d["y_ho"][:8], y_pred[:8])]


def train_gppvae(
    dataset: GridDataset,
    config: GPPVAETrainConfig,
    *,
    device: torch.device | str,
    init_params: dict | None = None,
    draws: Callable | None = None,
    log: MetricsLogger | None = None,
    group=None,
) -> GPPVAETrainResult:
    """Train; init_params may give 'vae', 'gp', 'rff' = (Ω, b) and
    'nystrom_idx' in place of the fresh ones (see _setup, _object_kernel).
    With config.resume, everything comes from that state instead and the
    run continues at its epoch. group: this rank's parallel.DataGroup or
    MeshGroup, every rank calling with the same arguments (see the module
    docstring); global rank 0 alone writes outdir and logs, the other ranks'
    log defaults to none. The result's model holds the full weights; its
    optimizers, on a mesh, the blocks."""
    with span("setup"):
        if config.mode not in ("joint", "dis"):
            raise ValueError(f"unknown mode {config.mode!r}; want 'joint' or 'dis'")
        init_params = dict(init_params or {})
        device = resolve_device(str(device))
        set_float32_precision(config.compute_dtype)
        shape = _shape_config(config, dataset)
        # before any work, and before outdir's files are touched
        resumed = _load_resume(config.resume, shape, device) if config.resume else None
        if resumed and resumed["object_kernel"] is not None:
            ok = resumed["object_kernel"]
            init_params.update(
                rff=(ok["omega"].cpu(), ok["phase"].cpu()),
                nystrom_idx=None if ok["nystrom_idx"] is None else ok["nystrom_idx"].cpu())
        writer = group is None or group.global_rank == 0
        own_log = log is None
        log = log or (MetricsLogger(config.outdir) if writer else NullLogger())
        outdir = config.outdir if writer else None
        if outdir:
            _write_sidecar(config, dataset, device)
        run_key = run_keys(config.seed)[0]
        model, gp_params, fixed_W, data, num_train = _setup(
            dataset, config, device, init_params, group)
        with span("setup.object_kernel"):
            x_map, x_draws = _object_kernel(config, gp_params["X"], init_params, device)
        accum = resolve_grad_accum(config.grad_accum_steps, num_train, config.batch_size)
        with span("setup.loop"):
            loop = _Loop(model, gp_params, fixed_W, data, num_train, config,
                         x_map=x_map, accum_steps=accum, group=group)
    start_epoch = 0
    if resumed:
        tp.load_state_dict(model, resumed["vae"])
        with torch.no_grad():
            for k, v in gp_params.items():
                v.copy_(resumed["gp"][k])
        if fixed_W is not None:
            loop.fixed_W = fixed_W = resumed["fixed_W"]
        loop.opt_vae.load_state_dict(resumed["opt_vae"])
        loop.opt_gp.load_state_dict(resumed["opt_gp"])
        start_epoch = int(resumed["epoch"])
    draws = draws or make_draws(run_key, num_train, config.batch_size, config.zdim)

    # the float32 polish tail (train_gppvae.py:799-847). Both Adams restart
    # at the switch when a bulk phase ran and this run crosses it, which
    # includes a resume at the boundary itself; a run resumed inside the
    # window is float32 from its first epoch and keeps the state's Adams,
    # which restarted before that state was written
    polish = _polish_epochs(config)
    bulk_end = config.epochs - polish
    if polish and start_epoch > bulk_end:
        model.dtype = torch.float32
    history: list[dict] = []
    with maybe_trace(config.profile_dir if writer else None, device):
        for epoch in range(start_epoch, config.epochs):
            if polish and epoch == bulk_end:
                model.dtype = torch.float32
                if bulk_end > 0:
                    loop.restart_optimizers()
            counts = None if group is None else collections.Counter(group.counts)
            metrics, seconds, y_pred = loop.run_epoch(draws, epoch)
            rec = {
                "driver": f"train_gppvae[{config.mode}]",
                "epoch": epoch,
                **metrics,
                "sec_epoch": sum(seconds.values()),
                **{f"sec_{k}": v for k, v in seconds.items()},
            }
            if group is not None:
                # a guarded step that one rank skipped alone would part the
                # replicas silently from here on
                params = [*loop.opt_vae.params, *loop.opt_gp.params]
                mask = [*loop.shards, *[False] * len(loop.opt_gp.params)]
                what = f"the parameters after epoch {epoch}"
                check_replicated(group, [p for p, s in zip(params, mask) if not s], what)
                if any(mask):
                    check_replicated(group, [p for p, s in zip(params, mask) if s],
                                     f"{what} (the blocks of split weights)", axis="data")
                rec["collectives"] = summary(group.counts - counts)
            log.log(rec)
            history.append(rec)
            if config.outdir:
                # one epoch per iteration, so the JAX trainer's dispatch
                # window (train_gppvae.py:970-975) is the plain epoch % every.
                # Every rank computes what is due (a mesh gathers); the
                # writer writes it
                last = epoch == config.epochs - 1
                if config.panel_every and (epoch % config.panel_every == 0 or last):
                    key = prng.fold_in(prng.fold_in(run_key, epoch), 2)
                    rows = _panel(loop, y_pred, key)
                    if outdir:
                        save_panel(os.path.join(outdir, f"panel_{epoch:04d}.png"), rows)
                if (config.checkpoint_every and epoch % config.checkpoint_every == 0
                        and not last):
                    state = _train_state(loop, x_draws, epoch + 1, shape)
                    if outdir:
                        save_tree(os.path.join(outdir, f"state_{epoch + 1:04d}"), state)

    # the result and the files hold the full weights (a mesh gathers them)
    tp.unsplit(model)
    final = _train_state(loop, x_draws, config.epochs, shape) if config.outdir else None
    if outdir:
        torch.save(
            {"vae": {k: v.cpu() for k, v in model.state_dict().items()},
             "gp": {k: v.detach().cpu() for k, v in gp_params.items()},
             "fixed_W": None if fixed_W is None else fixed_W.cpu(),
             "object_kernel": None if x_draws is None else
             {k: None if v is None else v.cpu() for k, v in x_draws.items()}},
            os.path.join(config.outdir, FINAL_PARAMS_FILE),
        )
        save_tree(os.path.join(config.outdir, FINAL_STATE_FILE), final)
    if own_log:
        log.close()
    return GPPVAETrainResult(model=model, gp_params=gp_params, fixed_W=fixed_W,
                             config=config, history=history, data=data, x_map=x_map,
                             optimizers={"vae": loop.opt_vae, "gp": loop.opt_gp})


def load_final(outdir: str, *, device: torch.device | str = "cpu",
               dataset: GridDataset | None = None) -> GPPVAETrainResult:
    """A finished run rebuilt from its outdir (config.json, final_params.pt):
    the model in the dtype it ended in, the GP params, the object-kernel
    map, and the data it trained on. The dataset is rebuilt from the
    sidecar's --data flag and grid unless given. history is empty and
    optimizers None."""
    device = resolve_device(str(device))
    with open(os.path.join(outdir, "config.json")) as f:
        saved = json.load(f)
    names = {f.name for f in dataclasses.fields(GPPVAETrainConfig)}
    config = GPPVAETrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in saved.items() if k in names})
    if dataset is None:
        grid = saved["dataset"]
        dataset = build_dataset_from_flag(config.data, grid["num_objects"], grid["num_views"],
                                          config.seed, image_size=grid["image_size"])
    final = torch.load(os.path.join(outdir, FINAL_PARAMS_FILE), map_location=device,
                       weights_only=True)
    model = vae_from_record(vars(config), dataset.image_shape,
                            dtype=torch.float32 if _polish_epochs(config) else None)
    model.load_state_dict(final["vae"])
    x_draws = final["object_kernel"]
    return GPPVAETrainResult(
        model=model.to(device), gp_params=final["gp"], fixed_W=final["fixed_W"],
        config=config, history=[], data=_data_tensors(dataset, device),
        x_map=None if x_draws is None else _x_map(config, x_draws))


def main(argv=None) -> GPPVAETrainResult:
    import argparse

    p = argparse.ArgumentParser(description="GPPVAE training (dis/joint)")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | sklearn | mnist:<dir> | faces[:h5:<path>] | npz:<path>")
    p.add_argument("--outdir", default="./out/gppvae")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mode", default="joint", choices=["joint", "dis"])
    p.add_argument("--vae_weights", default=None,
                   help="vae_weights.pt from train_vae (the handoff)")
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4, help="VAE learning rate")
    p.add_argument("--gp_lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_y", type=float, default=0.1)
    p.add_argument("--learn_sigma_y", action="store_true",
                   help="learn the decoder noise std (log-param in the GP group)")
    p.add_argument("--xdim", type=int, default=8, help="object feature rank M")
    p.add_argument("--view_freqs", type=int, default=3)
    p.add_argument("--view_feature_dim", type=int, default=None)
    p.add_argument("--object_kernel", default="linear", choices=list(gp.OBJECT_KERNELS))
    p.add_argument("--rff_features", type=int, default=32,
                   help="RFF rank for the rbf object kernels")
    p.add_argument("--rff_lengthscale", type=float, default=1.0)
    p.add_argument("--nystrom_rank", type=int, default=16,
                   help="landmark objects for --object_kernel rbf-nystrom")
    p.add_argument("--extra_effects", default="",
                   help="comma-separated random effects beyond object×view: object,view")
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    add_arch_flags(p, dtype_help="VAE compute dtype (params and the GP path stay float32)",
                   layout_help="port: one conv a stage and a hidden dense layer; facevae: "
                               "FaceVAE's two convs a stage, heads on the flat features "
                               "(models/vae.py)")
    p.add_argument("--polish_epochs", type=int, default=0,
                   help="with --dtype bfloat16: run the final K epochs in float32")
    p.add_argument("--clip_grad_norm", type=float, default=1e5)
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="one optimizer step per k minibatches; -1 = auto (N/bs)/45")
    p.add_argument("--refresh_every_steps", type=int, default=0,
                   help="re-expand the Taylor surrogate every k minibatch steps "
                        "(0 = once per epoch)")
    p.add_argument("--init_v_sig", type=float, default=1.0)
    p.add_argument("--init_v_noise", type=float, default=0.5)
    p.add_argument("--encode_chunk", type=int, default=1024)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--panel_every", type=int, default=10,
                   help="epochs between panel_NNNN.png (0 = off)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="epochs between state_NNNN checkpoints (0 = final_state only)")
    p.add_argument("--resume", default=None,
                   help="a state_NNNN or final_state to continue from, up to --epochs")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the epochs here")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ds = build_dataset_from_flag(args.data, args.num_objects, args.num_views,
                                 args.seed, image_size=args.image_size)
    config = GPPVAETrainConfig(
        mode=args.mode, epochs=args.epochs, batch_size=args.bs,
        lr_vae=args.lr, lr_gp=args.gp_lr, seed=args.seed, sigma_y=args.sigma_y,
        learn_sigma_y=args.learn_sigma_y,
        obj_feature_dim=args.xdim, view_num_freqs=args.view_freqs,
        view_feature_dim=args.view_feature_dim, object_kernel=args.object_kernel,
        rff_features=args.rff_features, rff_lengthscale=args.rff_lengthscale,
        nystrom_rank=args.nystrom_rank,
        extra_effects=tuple(e.strip() for e in args.extra_effects.split(",") if e.strip()),
        **arch_from_flags(args), polish_epochs=args.polish_epochs,
        clip_grad_norm=args.clip_grad_norm,
        grad_accum_steps=args.grad_accum_steps,
        refresh_every_steps=args.refresh_every_steps,
        init_v_sig=args.init_v_sig, init_v_noise=args.init_v_noise,
        encode_chunk=args.encode_chunk, vae_weights=args.vae_weights,
        resume=args.resume, profile_dir=args.profile_dir,
        outdir=args.outdir, panel_every=args.panel_every,
        checkpoint_every=args.checkpoint_every, data=args.data,
    )
    return train_gppvae(ds, config, device=device)


if __name__ == "__main__":
    main()
