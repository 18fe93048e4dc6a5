"""One GPPVAE-joint epoch on `world` ranks against one process, and the
functions the ranks run.

Counterpart of the JAX package's driver hook `dryrun_multichip`
(__graft_entry__.py:78-190): the same grid (8 objects × 8 views, 32²), the
same config (zdim 8, grad_accum_steps 2), the trainer on `world` ranks held
to the single-process run (every history key, rtol 1e-4), then the
communication: every rank holds the same parameters (bit for bit), no
collective is larger than the budget, and the collectives of an epoch are
the same at two dataset sizes (the counterpart of the HLO wire audit's two-N
differential). On the 1-D mesh the budget is the gradient all-reduce of the
two Adams' parameters. An even world of 4 or more runs, as the JAX hook
does, on a (world / 2) × 2 data × model mesh: tensor parallelism at the
default threshold (one weight splits at these widths, the encoder's dense),
`encode_chunk` 32 as the JAX wire audit pins it (__graft_entry__.py:176-185)
so that the model axis's activation gathers are chunk- or batch-sized, the
JAX audit's budget 2 × max(parameter bytes, 4·bs·pixels, the R-term)
(gppvae_tpu/parallel/spmd_audit.py:150-161), and per axis the same kinds and
calls at both sizes, with the same bytes on the data and world axes. The
model axis's bytes are not compared: in Phase C a data rank computes the
batch rows that lie in its block, as many as the epoch's plan puts there, so
the size of each activation gather follows the plan.

    python -m gppvae_tpu_torch.parallel.dryrun --world 2 [--device cpu] [--backend gloo]
    python -m gppvae_tpu_torch.parallel.dryrun --world 4 --device cpu   # the 2-D mesh

The device defaults to the card (cuda:0, every rank on card 0 over gloo);
without one it fails, and a CPU run asks for `--device cpu`.

The rank functions (`*_rank`) take the rank's DataGroup and then plain data,
which is pickled to the ranks: a dataset is named by the keyword arguments
of data.build_rotated_digits and rebuilt on each rank, a config is a dict of
the trainer's dataclass fields, injected draws are lists of numpy arrays by
epoch; `tp_min_size` sets the tensor-parallel threshold inside the rank
(`tp_threshold`, the counterpart of the JAX test's monkeypatch of
`shard_params_model_axis`). tests/test_torch_parallel.py,
tests/test_torch_tp.py and chip_smoke.py paths 9 and 10 run them too.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import hashlib
import json

import numpy as np
import torch

from gppvae_tpu_torch import ops
from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.parallel import tensor
from gppvae_tpu_torch.parallel.collectives import check_replicated, gather, summary
from gppvae_tpu_torch.parallel.launch import RankPool
from gppvae_tpu_torch.parallel.mesh import row_block, shard_rows
from gppvae_tpu_torch.train.device import resolve_device
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


def dryrun_mesh(world: int) -> tuple[int, int] | None:
    """__graft_entry__.py:120-123: an even world of 4 or more is a
    (world / 2) × 2 data × model mesh, any other the 1-D data mesh (None)."""
    return (world // 2, 2) if world % 2 == 0 and world >= 4 else None


@contextlib.contextmanager
def tp_threshold(min_size: int | None):
    """The trainer's `split_model_axis` with another threshold, inside the
    block (None: unchanged); the rank's module state is restored after."""
    from gppvae_tpu_torch.train import train_gppvae as tg

    saved = tg.split_model_axis
    if min_size is not None:
        tg.split_model_axis = functools.partial(tensor.split_model_axis, min_size=min_size)
    try:
        yield
    finally:
        tg.split_model_axis = saved


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
    the run), 'digest' of the final parameters (whole), 'params' (numpy,
    whole), 'blocks' (numpy: on a mesh, this rank's blocks of the split
    weights, by name)}."""
    from gppvae_tpu_torch.train import train_gppvae as tg

    cfg = tg.GPPVAETrainConfig(**{**config, "outdir": outdir, "resume": resume})
    ops.reset_launch_counts()
    res = tg.train_gppvae(build_rotated_digits(**data), cfg, device=device,
                          init_params=init_params, draws=_draws(draws),
                          log=None if outdir else NullLogger(), group=group)
    names = [k for k, _ in res.model.named_parameters()]
    opt = res.optimizers["vae"]
    blocks = {k: p.detach().cpu().numpy() for k, p, is_block in
              zip(names, opt.params, opt.shards or []) if is_block}
    gp = [res.gp_params[k] for k in sorted(res.gp_params)]
    return {"history": res.history, "launches": ops.launch_counts(),
            "digest": params_digest([*res.model.parameters(), *gp]), "blocks": blocks,
            "params": {"vae": {k: v.cpu().numpy() for k, v in res.model.state_dict().items()},
                       "gp": {k: v.detach().cpu().numpy() for k, v in res.gp_params.items()}}}


def train_gppvae_rank(group, data: dict, config: dict, init_params=None, draws=None,
                      outdir=None, resume=None, tp_min_size: int | None = None) -> dict:
    """train_gppvae on this rank (its device); global rank 0 writes outdir."""
    with tp_threshold(tp_min_size):
        return train_gppvae(data, config, group.device, init_params=init_params,
                            draws=draws, outdir=outdir, resume=resume, group=group)


def check_blocks(ranks: list[dict], model_size: int) -> list[str]:
    """Raise unless every rank's blocks are its model index's rows of the
    whole weights it returned (model index = global rank mod model_size);
    returns the names of the split weights."""
    for rank, r in enumerate(ranks):
        for name, block in r["blocks"].items():
            whole = r["params"]["vae"][name]
            k = whole.shape[0] // model_size
            j = rank % model_size
            if not np.array_equal(block, whole[j * k:(j + 1) * k]):
                raise AssertionError(f"rank {rank}: {name}'s block is not rows "
                                     f"{j * k}:{(j + 1) * k} of the whole weight")
    return sorted(ranks[0]["blocks"])


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


def column_parallel_rank(group, kind: str, weight: np.ndarray, bias: np.ndarray,
                         x: np.ndarray, dy: np.ndarray, dtype: str = "float32") -> dict:
    """One conv ('conv': OIHW weight, 3×3, padding 1, NCHW x; 'upconv': the
    same layer after a nearest-resize ×2, as the subpixel decoder runs it)
    or dense ('dense': (out, in) weight) layer with its weight split over
    the model axis (every weight splits: min_size 1), run as models/vae.py
    runs it in the compute dtype `dtype`: the output, and the gradients of
    sum(output · dy) for x, the weight (gathered whole) and the bias; numpy
    float32, with the collectives issued."""
    from gppvae_tpu_torch.models import vae

    dev = group.device
    w = torch.as_tensor(weight)
    layer = (torch.nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], padding=w.shape[2] // 2)
             if kind != "dense" else torch.nn.Linear(w.shape[1], w.shape[0])).to(dev)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(torch.as_tensor(bias))
    split = tensor.split_model_axis(layer, group, min_size=1)
    counts = collections.Counter(group.counts)
    xt = torch.tensor(x, device=dev, requires_grad=True)
    y = {"conv": _conv_nchw, "upconv": vae._upconv, "dense": vae._dense}[kind](
        layer, xt, getattr(torch, dtype))
    torch.sum(y.float() * torch.as_tensor(dy, device=dev)).backward()
    issued = summary(group.counts - counts)
    dw = gather(group, layer.weight.grad, 0)
    out = {k: t.detach().float().cpu().numpy() for k, t in
           dict(y=y, dx=xt.grad, dw=dw, db=layer.bias.grad).items()}
    return {**out, "split": split, "block_rows": layer.weight.shape[0], "collectives": issued}


def _conv_nchw(layer, x, dtype):
    """models/vae.py's `_conv3x3` (the port's kernels on a float32 CUDA
    tensor) on an NCHW x, without ELU: NCHW out."""
    from gppvae_tpu_torch.models import vae

    return vae._conv3x3(layer, x.permute(0, 2, 3, 1), dtype).permute(0, 3, 1, 2)


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


def _signature(history: list[dict], exact: bool = True) -> list:
    """Each epoch's collectives; with exact=False the model axis's by kind
    and calls only (see the module docstring)."""
    return [{k: row if exact or not k.startswith("model.") else {"calls": row["calls"]}
             for k, row in h["collectives"].items()} for h in history]


def wire_budget(config: dict, data: dict, n_params: int) -> int:
    """The JAX wire audit's budget (spmd_audit.py:150-161): twice the largest
    of the parameter bytes, a float32 batch of images and the R-term."""
    bs, zdim = config["batch_size"], config["zdim"]
    pixels = data["image_size"] ** 2  # one channel: rotated digits
    rank = config["obj_feature_dim"] * (2 * config["view_num_freqs"] + 1)
    return 2 * max(4 * n_params, 4 * bs * pixels,
                   4 * (rank * (rank + zdim + bs) + bs * pixels))


def dryrun(world: int = 2, *, device: str = "cuda:0", backend: str = "gloo",
           pool: RankPool | None = None) -> dict:
    """One GPPVAE-joint epoch on `world` ranks (those of `pool`, or new
    ones; a pool of an even world ≥ 4 is the (world / 2) × 2 mesh,
    `dryrun_mesh`) against one process on `device` (see the module
    docstring); raises on any disagreement. Returns what it checked."""
    resolve_device(device)  # fails without a card unless asked for the CPU
    mesh = dryrun_mesh(world)
    if pool is not None and (pool.world, pool.mesh) != (world, mesh):
        raise ValueError(f"dryrun({world}) runs on {world} ranks as mesh {mesh}; the pool "
                         f"has {pool.world} as {pool.mesh}")
    config = dryrun_config(world)
    if mesh is not None:
        config["encode_chunk"] = 32
    # the same grid without validation rows: 56 training rows against 53, as
    # many Phase-C steps at bs 2·world
    other = {**DRYRUN_DATA, "val_fraction": 0.0}
    with contextlib.nullcontext(pool) if pool is not None else RankPool(
            world, backend=backend, device=device, mesh=mesh) as ranks_pool:
        ranks = ranks_pool.run(train_gppvae_rank, DRYRUN_DATA, config)
        ranks_other = ranks_pool.run(train_gppvae_rank, other, config)
    single = train_gppvae(DRYRUN_DATA, config, device)
    for k in KEYS:
        for r in ranks:
            np.testing.assert_allclose(r["history"][0][k], single["history"][0][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{world} ranks vs one process: {k}")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' parameters differ")
    n_params = sum(a.size for part in single["params"].values() for a in part.values())
    out = {"world": world, "mesh": mesh, "device": device, "backend": backend}
    if mesh is None:
        budget = 4 * (n_params + 6)  # the gradient all-reduce and the step's sums
    else:
        budget = wire_budget(config, DRYRUN_DATA, n_params)
        out["split"] = check_blocks(ranks, mesh[1])
        if not out["split"]:
            raise AssertionError("no weight split over the model axis")
    # alike on every rank; the model axis's bytes alike within a model row
    exact, m = mesh is None, mesh[1] if mesh else 1
    sig = _signature(ranks[0]["history"])
    for rank, r in enumerate(ranks):
        if (_signature(r["history"]) != _signature(ranks[rank - rank % m]["history"])
                or _signature(r["history"], exact) != _signature(ranks[0]["history"], exact)):
            raise AssertionError(f"rank {rank} issued other collectives than rank 0")
    worst = max(row["max_bytes"] for r in ranks for epoch in _signature(r["history"])
                for row in epoch.values())
    if worst > budget:
        raise AssertionError(f"a collective of {worst} bytes exceeds the budget {budget}")
    n_train = [len(build_rotated_digits(**d).train_idx) for d in (DRYRUN_DATA, other)]
    for r, ro in zip(ranks, ranks_other):
        if _signature(ro["history"], exact) != _signature(r["history"], exact):
            raise AssertionError(f"the collectives of an epoch change with N {n_train}: "
                                 f"{_signature(r['history'], exact)} vs "
                                 f"{_signature(ro['history'], exact)}")
    return {**out, "history": {k: ranks[0]["history"][0][k] for k in KEYS},
            "collectives": sig[0], "budget_bytes": budget, "max_bytes": worst,
            "n_train": n_train, "launches": [r["launches"] for r in ranks]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="one GPPVAE-joint epoch on N ranks vs one process")
    p.add_argument("--world", type=int, default=2,
                   help="ranks; an even world of 4 or more is the (world/2) × 2 mesh")
    p.add_argument("--device", default="cuda:0",
                   help="cuda:K (every rank on card K; the default cuda:0), cuda or cpu")
    p.add_argument("--backend", default="gloo", help="gloo or nccl")
    args = p.parse_args(argv)
    out = dryrun(args.world, device=args.device, backend=args.backend)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
