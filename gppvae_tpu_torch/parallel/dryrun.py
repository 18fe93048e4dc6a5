"""One GPPVAE-joint epoch on `world` ranks against one process, and the
functions the ranks run.

Counterpart of the JAX package's driver hook `dryrun_multichip`
(__graft_entry__.py:78-190): the same grid (8 objects × 8 views, 32²), the
same config (zdim 8, grad_accum_steps 2), the trainer on `world` ranks held
to the single-process run (every history key, rtol 1e-4), then the
communication: every rank holds the same parameters (bit for bit), no
collective is larger than the gradient all-reduce of the two Adams'
parameters (the budget), and the collectives of an epoch are the same at two
dataset sizes (the counterpart of the HLO wire audit's two-N differential).

    python -m gppvae_tpu_torch.parallel.dryrun --world 2 [--device cpu] [--backend gloo]

The rank functions (`*_rank`) take the rank's DataGroup and then plain data,
which is pickled to the ranks: a dataset is named by the keyword arguments
of data.build_rotated_digits and rebuilt on each rank, a config is a dict of
the trainer's dataclass fields, injected draws are lists of numpy arrays by
epoch. tests/test_torch_parallel.py and chip_smoke.py path 9 run them too.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import json

import numpy as np
import torch

from gppvae_tpu_torch import ops
from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.parallel.collectives import check_replicated, summary
from gppvae_tpu_torch.parallel.launch import RankPool
from gppvae_tpu_torch.parallel.mesh import row_block, shard_rows
from gppvae_tpu_torch.utils import NullLogger

# the history keys a data-parallel run is held to (__graft_entry__.py:148)
KEYS = ("loss", "recon_term", "gp_term", "pen_term", "mse", "gp_nll_full", "v_sig",
        "v_noise", "oos_mse")
DRYRUN_DATA = dict(source="synthetic", num_objects=8, num_views=8, image_size=32, seed=0)


def dryrun_config(world: int) -> dict:
    """__graft_entry__.py:133-137's config."""
    return dict(mode="joint", zdim=8, epochs=1, batch_size=max(world, 2) * 2,
                obj_feature_dim=4, view_num_freqs=1, enc_features=(8, 16),
                dec_features=(16, 8), grad_accum_steps=2)


def _draws(draws):
    """draws(epoch) → torch tensors from a list of numpy arrays by epoch (the
    first, the plan's positions, as int64)."""
    if draws is None:
        return None
    return lambda epoch: (torch.tensor(draws[epoch][0], dtype=torch.int64),
                          *(torch.tensor(a) for a in draws[epoch][1:]))


def params_digest(tensors) -> str:
    """sha256 of the tensors' bytes in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_gppvae(data: dict, config: dict, device, *, init_params=None, draws=None,
                 outdir=None, resume=None, group=None) -> dict:
    """One train_gppvae run: {'history', 'launches' (ops.launch_counts over
    the run), 'digest' of the final parameters, 'params' (numpy)}."""
    from gppvae_tpu_torch.train import train_gppvae as tg

    cfg = tg.GPPVAETrainConfig(**{**config, "outdir": outdir, "resume": resume})
    ops.reset_launch_counts()
    res = tg.train_gppvae(build_rotated_digits(**data), cfg, device=device,
                          init_params=init_params, draws=_draws(draws),
                          log=None if outdir else NullLogger(), group=group)
    params = [*res.optimizers["vae"].params, *res.optimizers["gp"].params]
    return {"history": res.history, "launches": ops.launch_counts(),
            "digest": params_digest(params),
            "params": {"vae": {k: v.cpu().numpy() for k, v in res.model.state_dict().items()},
                       "gp": {k: v.detach().cpu().numpy() for k, v in res.gp_params.items()}}}


def train_gppvae_rank(group, data: dict, config: dict, init_params=None, draws=None,
                      outdir=None, resume=None) -> dict:
    """train_gppvae on this rank (its device); rank 0 writes outdir."""
    return train_gppvae(data, config, group.device, init_params=init_params, draws=draws,
                        outdir=outdir, resume=resume, group=group)


def train_vae(data: dict, config: dict, device, *, init_params=None, draws=None,
              group=None) -> dict:
    """One train_vae run: {'history', 'digest' of the final parameters}."""
    from gppvae_tpu_torch.train import train_vae as tv

    res = tv.train_vae(build_rotated_digits(**data), tv.VAETrainConfig(**config),
                       device=device, log=NullLogger(), init_params=init_params,
                       draws=_draws(draws), group=group)
    return {"history": res.history, "digest": params_digest(res.model.parameters())}


def train_vae_rank(group, data: dict, config: dict, init_params=None, draws=None) -> dict:
    return train_vae(data, config, group.device, init_params=init_params, draws=draws,
                     group=group)


def factor_prep_rank(group, U: np.ndarray, Z: np.ndarray) -> dict:
    """ops.factor_prep of the rank's block of rows of U, Z, summed over the
    ranks, and the gradients of sum(G²) + sum(UᵀZ) + ‖Z‖² for its rows
    (each rank differentiates its share, the value / world); numpy, with
    the kernels' launch counts of the call."""
    rows = row_block(len(U), group)
    u, z = (torch.tensor(a[rows], device=group.device, requires_grad=True) for a in (U, Z))
    ops.reset_launch_counts()
    G, UtZ, zn = ops.factor_prep(u, z, group)
    loss = torch.sum(G * G) + torch.sum(UtZ) + zn
    du, dz = torch.autograd.grad(loss / group.world, (u, z))
    out = {k: t.detach().cpu().numpy() for k, t in
           dict(G=G, UtZ=UtZ, zn=zn, dU=du, dZ=dz).items()}
    return {**out, "launches": ops.launch_counts()}


def serving_rank(group, model_kw: dict, params: dict, fixed_W, images_tr, d_tr, q_tr,
                 d_ho, q_ho, y_obs, encode_chunk: int = 1024) -> dict:
    """The data-parallel serving calls (numpy in, numpy out): the fold of
    the rank's block of the training rows, predict_images of the cells
    (d_ho, q_ho) with variances, observe of the rank's block of y_obs (the
    images of those cells), and predict_images again. Returns both cores'
    M, the replies and the collectives the calls issued."""
    from gppvae_tpu_torch.eval import serving

    dev = group.device
    model = VAE(**model_kw).to(dev)

    def t(a, dtype=None):
        return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    state_params = {"vae": {k: t(v) for k, v in params["vae"].items()},
                    "gp": {k: t(v) for k, v in params["gp"].items()}}
    images_tr, d_tr, q_tr = shard_rows(group, images_tr, d_tr, q_tr)
    y_obs, d_obs, q_obs = shard_rows(group, y_obs, d_ho, q_ho)
    d_ho, q_ho = t(d_ho, torch.int64), t(q_ho, torch.int64)
    counts = collections.Counter(group.counts)
    state = serving.build_server_state(
        model, state_params, t(fixed_W), t(images_tr), t(d_tr, torch.int64),
        t(q_tr, torch.int64), encode_chunk=encode_chunk, group=group)
    y, var = serving.predict_images(model, state, d_ho, q_ho, return_var=True, group=group)
    state2 = serving.observe(model, state, t(y_obs), t(d_obs, torch.int64),
                             t(q_obs, torch.int64), encode_chunk=encode_chunk, group=group)
    y2 = serving.predict_images(model, state2, d_ho, q_ho, group=group)
    out = {k: v.cpu().numpy() for k, v in
           dict(M=state.core.M, M2=state2.core.M, y=y, var=var, y2=y2).items()}
    return {**out, "collectives": summary(group.counts - counts)}


def perturbed_check_rank(group, differ: bool = True) -> str:
    """check_replicated of a tensor that rank 1 holds one bit apart when
    `differ`: the error the rank got, or ''."""
    t = torch.arange(6, dtype=torch.float32, device=group.device)
    if differ and group.rank == 1:
        t[3] = torch.nextafter(t[3], t[4])
    try:
        check_replicated(group, [t], "a test tensor")
    except RuntimeError as err:
        return str(err)
    return ""


def _signature(history: list[dict]) -> list:
    return [h["collectives"] for h in history]


def dryrun(world: int = 2, *, device: str = "cpu", backend: str = "gloo",
           pool: RankPool | None = None) -> dict:
    """One GPPVAE-joint epoch on `world` ranks (those of `pool`, or new
    ones) against one process (see the module docstring); raises on any
    disagreement. Returns what it checked."""
    config = dryrun_config(world)
    # the same grid without validation rows: 56 training rows against 53, as
    # many Phase-C steps at bs 2·world
    other = {**DRYRUN_DATA, "val_fraction": 0.0}
    with contextlib.nullcontext(pool) if pool is not None else RankPool(
            world, backend=backend, device=device) as ranks_pool:
        ranks = ranks_pool.run(train_gppvae_rank, DRYRUN_DATA, config)
        ranks_other = ranks_pool.run(train_gppvae_rank, other, config)
    single = train_gppvae(DRYRUN_DATA, config, device)
    for k in KEYS:
        for r in ranks:
            np.testing.assert_allclose(r["history"][0][k], single["history"][0][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{world} ranks vs one process: {k}")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' parameters differ")
    sig = _signature(ranks[0]["history"])
    if any(_signature(r["history"]) != sig for r in ranks):
        raise AssertionError("the ranks issued different collectives")
    n_params = sum(a.size for part in single["params"].values() for a in part.values())
    budget = 4 * (n_params + 6)  # the gradient all-reduce and the step's sums
    worst = max(row["max_bytes"] for epoch in sig for row in epoch.values())
    if worst > budget:
        raise AssertionError(f"a collective of {worst} bytes exceeds the budget {budget}")
    n_train = [len(build_rotated_digits(**d).train_idx) for d in (DRYRUN_DATA, other)]
    if _signature(ranks_other[0]["history"]) != sig:
        raise AssertionError(f"the collectives of an epoch change with N {n_train}: "
                             f"{sig} vs {_signature(ranks_other[0]['history'])}")
    return {"world": world, "device": device, "backend": backend,
            "history": {k: ranks[0]["history"][0][k] for k in KEYS},
            "collectives": sig[0], "budget_bytes": budget, "max_bytes": worst,
            "n_train": n_train, "launches": [r["launches"] for r in ranks]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="one GPPVAE-joint epoch on N ranks vs one process")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cpu", help="cpu, cuda:K (every rank on card K) or cuda")
    p.add_argument("--backend", default="gloo", help="gloo or nccl")
    args = p.parse_args(argv)
    out = dryrun(args.world, device=args.device, backend=args.backend)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
