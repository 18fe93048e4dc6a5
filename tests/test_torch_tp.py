"""The port's 2-D data × model mesh (tensor parallelism,
gppvae_tpu_torch/parallel/tensor.py) against the JAX package's make_mesh_2d.

The port's ranks are torch.distributed processes on the CPU over gloo: one
pool of 4 ranks as a 2 × 2 mesh, started once for this module and given one
function of gppvae_tpu_torch.parallel.dryrun per case (the ranks never
import jax). The JAX side runs on conftest's virtual CPU devices, fed the
same numpy inputs: the JAX trainer's own initial params and its draws
(tests/test_torch_parallel.py's injection). Tolerances (float32):
  (i)   a split conv and dense layer on 2 model ranks against the unsplit
        layer, output and the gradients of x, the weight and the bias:
        rtol 1e-6, atol 1e-6 · the largest magnitude (x's gradient is the
        model ranks' two partial sums added: a regrouped float32 sum, whose
        error near zero is relative to the largest term, not the element);
  (ii)  the split rule against shard_params_model_axis on make_mesh_2d(4, 2):
        the same weights split, at the published widths and default
        threshold, and at SMALL's widths with min_size 1 << 8;
  (iii) GPPVAE-joint, 2 epochs, on 2 × 2 at min_size 1 << 8 against
        train_gppvae(mesh=make_mesh_2d(2, 2)) under the same threshold and
        against the port's single process: rtol 1e-4, atol 1e-6
        (tests/test_parallel.py:352-393's bound); with clipping on every
        step against one process, the same;
  (iv)  a non-dividing weight warns once, naming it; a dividing one is silent;
  (v)   a 2 × 2 run's final_params.pt and final_state load into one process,
        and a resume on 2 × 2 equals the same resume in one process (rtol
        1e-4); train_vae on 2 × 2 equals one process (rtol 1e-4);
  (vi)  dryrun.dryrun(4) on the pool: the 2-D branch's checks.
"""

import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gppvae_tpu.data import build_rotated_digits as jax_digits
from gppvae_tpu.models import VAE as JaxVAE
from gppvae_tpu.parallel import make_mesh_2d, shard_params_model_axis
from gppvae_tpu.train.batching import epoch_batches as jax_epoch_batches
from gppvae_tpu.train.batching import epoch_keys
from gppvae_tpu.utils.metrics import NullLogger
from gppvae_tpu_torch import parallel
from gppvae_tpu_torch.convert import flax_to_state_dict
from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.parallel import MeshGroup, dryrun, tensor
from gppvae_tpu_torch.train import train_gppvae as tg
from _one_thread import one_thread  # noqa: F401

jtrain = importlib.import_module("gppvae_tpu.train.train_gppvae")

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")

SMALL = dict(mode="joint", zdim=8, epochs=2, batch_size=16, obj_feature_dim=4,
             view_num_freqs=2, enc_features=(8, 16), dec_features=(16, 8))
GRID = (16, 8)  # tests/test_parallel.py:352-393's grid
TP_MIN = 1 << 8  # the JAX test's lowered threshold
KEYS = ("loss", "recon_term", "gp_term", "gp_nll_full", "oos_mse", "v_sig", "v_noise")
# at the published widths and model axis 2 (torch shapes, out first)
PUBLISHED_SPLIT = {"encoder.convs.1.weight", "encoder.convs.2.weight", "encoder.dense.weight",
                   "decoder.dense.weight", "decoder.convs.0.weight", "decoder.convs.1.weight",
                   "decoder.convs.2.weight"}


@pytest.fixture(scope="module")
def mesh_pool():
    """4 gloo ranks as a 2 × 2 data × model mesh (again after a rank's
    failure closed it)."""
    pools = []

    def get():
        if not pools or pools[-1].closed:
            pools.append(parallel.RankPool(4, backend="gloo", device="cpu", mesh=(2, 2)))
        return pools[-1]

    yield get
    for pool in pools:
        pool.close()


def _data(grid=GRID):
    return dict(source="synthetic", num_objects=grid[0], num_views=grid[1], seed=0)


def _jax_plan(rng, epoch, num_train, bs, zdim):
    """The JAX trainer's draws for one epoch (train_gppvae.py:456,507-508)."""
    key = epoch_keys(rng, epoch, 1)[0]
    batches, weights = jax_epoch_batches(key, num_train, bs)
    step_keys = jax.random.split(jax.random.fold_in(key, 1), batches.shape[0])
    eps = jnp.stack([jax.random.normal(k, (bs, zdim), jnp.float32) for k in step_keys])
    return [np.asarray(a) for a in (batches, weights, eps)]


@functools.cache
def _jax_run():
    """(the port's inputs: the JAX trainer's initial params and draws, the
    JAX 2 × 2 mesh history at min_size 1 << 8)."""
    ds = jax_digits("synthetic", num_objects=GRID[0], num_views=GRID[1], seed=0)
    jcfg = jtrain.GPPVAETrainConfig(**SMALL)
    _, params, _, _, rng, n = jtrain._setup(ds, jcfg, None, None)
    init = {"vae": {k: v.numpy() for k, v in
                    flax_to_state_dict(jax.tree.map(np.asarray, params["vae"])).items()},
            "gp": {k: np.asarray(v) for k, v in params["gp"].items()}}
    draws = [_jax_plan(rng, e, n, jcfg.batch_size, jcfg.zdim) for e in range(jcfg.epochs)]
    saved = jtrain.shard_params_model_axis
    jtrain.shard_params_model_axis = functools.partial(saved, min_size=TP_MIN)
    try:
        hist = jtrain.train_gppvae(ds, jcfg, mesh=make_mesh_2d(2, 2), log=NullLogger()).history
    finally:
        jtrain.shard_params_model_axis = saved
    return init, draws, hist


def _close(ours, want, where):
    for a, b in zip(ours, want, strict=True):
        for k in KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{where}: {k}, epoch {a['epoch']}")


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_column_parallel_layer_matches_unsplit(mesh_pool, kind):
    """(i) copy_to_model → the block's product → gather_columns → + bias on
    2 model ranks (each data row of the mesh runs it) against the unsplit
    layer: output and gradients, the bias added after the gather."""
    rng = np.random.default_rng(5)
    if kind == "conv":
        w = rng.standard_normal((16, 8, 3, 3)).astype(np.float32) / 8
        x = rng.standard_normal((5, 8, 6, 6)).astype(np.float32)
        dy = rng.standard_normal((5, 16, 6, 6)).astype(np.float32)
    else:
        w = rng.standard_normal((12, 20)).astype(np.float32) / 4
        x = rng.standard_normal((7, 20)).astype(np.float32)
        dy = rng.standard_normal((7, 12)).astype(np.float32)
    b = rng.standard_normal(w.shape[0]).astype(np.float32)
    wt, bt = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = (torch.nn.functional.conv2d(xt, wt, bt, padding=1) if kind == "conv"
         else torch.nn.functional.linear(xt, wt, bt))
    torch.sum(y * torch.tensor(dy)).backward()
    want = {"y": y, "dx": xt.grad, "dw": wt.grad, "db": bt.grad}
    ranks = mesh_pool().run(dryrun.column_parallel_rank, kind, w, b, x, dy)
    for rank, r in enumerate(ranks):
        assert r["split"] == ["weight"] and r["block_rows"] == w.shape[0] // 2
        for name, t in want.items():
            t = t.detach().numpy()
            np.testing.assert_allclose(r[name], t, rtol=1e-6, atol=1e-6 * np.abs(t).max(),
                                       err_msg=f"rank {rank} {kind} {name}")
        # forward: one gather of the output; backward: one sum of dx
        assert r["collectives"] == {
            "model.gather": {"calls": 1, "bytes": y.numel() * 4, "max_bytes": y.numel() * 4},
            "model.all_reduce": {"calls": 1, "bytes": x.size * 4, "max_bytes": x.size * 4}}


def _jax_split(cfg, grid, min_size):
    """The port's names of the VAE weights that shard_params_model_axis
    shards over make_mesh_2d(4, 2)'s model axis, given the JAX trainer's
    parameter tree (its shapes, from jax.eval_shape of the flax init, and
    the GP parameters of _setup); none of the GP parameters may shard."""
    model = JaxVAE(zdim=cfg.zdim, image_shape=(32, 32, 1), enc_features=cfg.enc_features,
                   dec_features=cfg.dec_features)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
                            jax.random.PRNGKey(1))
    gp = {"X": (grid[0], cfg.obj_feature_dim), "log_vs": (1,), "log_vn": (),
          "W": (grid[1], 2 * cfg.view_num_freqs + 1)}
    params = {"vae": jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), shapes),
              "gp": {k: jnp.zeros(v, jnp.float32) for k, v in gp.items()}}
    kw = {} if min_size is None else {"min_size": min_size}
    out = shard_params_model_axis(make_mesh_2d(4, 2), params, **kw)
    flags = jax.tree.map(lambda x: np.full(
        x.shape, float("model" in str(x.sharding.spec)), np.float32), out)
    assert not any(np.any(f) for f in jax.tree.leaves(flags["gp"]))
    return {k for k, v in flax_to_state_dict(flags["vae"]).items() if v.numel() and v.max() > 0}


@pytest.mark.parametrize("widths", ["published", "small"])
def test_split_rule_matches_shard_params_model_axis(widths):
    """(ii) the same weights split as the JAX trainer's shard_params_model_axis
    on make_mesh_2d(4, 2): the seven of the issue at the published widths
    (default threshold), and at SMALL's widths with min_size 1 << 8 (≥ 3, as
    tests/test_parallel.py asserts); each split weight keeps its block of
    output features."""
    if widths == "published":
        grid, over, min_size = (400, 16), {"mode": "joint"}, None
    else:
        grid, over, min_size = GRID, SMALL, TP_MIN
    cfg = jtrain.GPPVAETrainConfig(**over)
    want = _jax_split(cfg, grid, min_size)
    model = VAE(cfg.zdim, (32, 32, 1), cfg.enc_features, cfg.dec_features)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    group = MeshGroup(rank=1, world=4, device=torch.device("cpu"), model_rank=1, model_size=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # every weight divides
        split = tensor.split_model_axis(model, group, min_size=min_size or tensor.MIN_SIZE)
    assert set(split) == want
    if widths == "published":
        assert want == PUBLISHED_SPLIT
    else:
        assert len(split) >= 3
    for name, v in model.state_dict().items():
        k = whole[name].shape[0] // 2
        assert torch.equal(v, whole[name][k:] if name in split else whole[name]), name


def test_tp_warns_on_nondivisible_weights():
    """(iv) a weight large enough whose output dimension does not divide the
    model axis stays whole, with one warning naming it (REPLICATED, as the
    JAX warning says); a dividing one splits without a warning."""
    group = MeshGroup(rank=0, world=4, device=torch.device("cpu"), model_rank=0, model_size=2)
    bad = torch.nn.Sequential()
    bad.dense = torch.nn.Linear(64, 65)  # 65 output features
    with pytest.warns(UserWarning, match=r"REPLICATED.*dense\.weight \(65, 64\)") as caught:
        assert tensor.split_model_axis(bad, group, min_size=1 << 8) == []
    assert len(caught) == 1 and bad.dense.weight.shape == (65, 64)
    assert getattr(bad.dense, "tp_group", None) is None

    good = torch.nn.Sequential()
    good.dense = torch.nn.Linear(64, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tensor.split_model_axis(good, group, min_size=1 << 8) == ["dense.weight"]
    assert good.dense.weight.shape == (32, 64) and good.dense.tp_group is group


def test_mesh_run_matches_jax_make_mesh_2d(mesh_pool):
    """(iii) the counterpart of test_tp_sharded_kernels_match_single_device:
    2 × 2 ranks at min_size 1 << 8 against the JAX trainer on make_mesh_2d(2,
    2) at the same threshold and against the port's one process; every rank
    holds the same whole parameters, and its blocks are its rows of them."""
    init, draws, jax_hist = _jax_run()
    ranks = mesh_pool().run(dryrun.train_gppvae_rank, _data(), SMALL, init, draws, None, None,
                            TP_MIN)
    one = dryrun.train_gppvae(_data(), SMALL, "cpu", init_params=init, draws=draws)
    for rank, r in enumerate(ranks):
        _close(r["history"], jax_hist, f"rank {rank} against the JAX mesh")
        _close(r["history"], one["history"], f"rank {rank} against one process")
        coll = r["history"][0]["collectives"]
        assert {"all_reduce", "model.gather", "model.all_reduce", "model.broadcast",
                "world.all_reduce"} <= set(coll), coll
    assert len(dryrun.check_blocks(ranks, 2)) >= 3
    assert len({r["digest"] for r in ranks}) == 1
    assert set(ranks[0]["launches"].values()) == {0}  # the CPU: plain versions only


def test_mesh_clipped_steps_match_one_process(mesh_pool):
    """(iii) clip_grad_norm low enough to clip every step: the guarded Adam's
    Σg² over the blocks (summed over the model axis) and the replicated
    tensors gives one process's trajectory; the clipped run is not the
    unclipped one."""
    init, draws, _ = _jax_run()
    config = {**SMALL, "clip_grad_norm": 1.0}
    ranks = mesh_pool().run(dryrun.train_gppvae_rank, _data(), config, init, draws, None, None,
                            TP_MIN)
    one = dryrun.train_gppvae(_data(), config, "cpu", init_params=init, draws=draws)
    free = dryrun.train_gppvae(_data(), SMALL, "cpu", init_params=init, draws=draws)
    for rank, r in enumerate(ranks):
        _close(r["history"], one["history"], f"rank {rank}, clipped, against one process")
    last, unclipped = one["history"][-1]["loss"], free["history"][-1]["loss"]
    assert abs(last - unclipped) > 1e-3 * abs(unclipped), "clipping changed nothing"


def test_mesh_state_loads_in_one_process_and_resumes(mesh_pool, tmp_path):
    """(v) a 2 × 2 run's final_params.pt loads into the single-process model
    (load_final) with the whole weights the ranks returned; its final_state
    resumed for a third epoch on 2 × 2 equals the same resume in one
    process (rtol 1e-4)."""
    pool = mesh_pool()
    config = {**SMALL, "epochs": 2}
    ranks = pool.run(dryrun.train_gppvae_rank, _data((11, 8)), config, None, None,
                     str(tmp_path / "mesh"), None, TP_MIN)
    loaded = tg.load_final(str(tmp_path / "mesh"), device="cpu",
                           dataset=build_rotated_digits(**_data((11, 8))))
    for name, v in loaded.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ranks[0]["params"]["vae"][name], err_msg=name)
    for name, v in loaded.gp_params.items():
        np.testing.assert_array_equal(v.numpy(), ranks[0]["params"]["gp"][name], err_msg=name)
    state = str(tmp_path / "mesh" / "final_state")
    more = {**config, "epochs": 3}
    resumed = pool.run(dryrun.train_gppvae_rank, _data((11, 8)), more, None, None, None,
                       state, TP_MIN)
    alone = dryrun.train_gppvae(_data((11, 8)), more, "cpu", resume=state)
    assert [h["epoch"] for h in alone["history"]] == [2]
    for r in resumed:
        assert [h["epoch"] for h in r["history"]] == [2]
        _close(r["history"], alone["history"], "2 × 2 resume against one process")
    assert (tmp_path / "mesh" / "metrics.jsonl").is_file()


def test_train_vae_on_mesh_matches_one_process(mesh_pool):
    """(v) train_vae on 2 × 2 (no tensor parallelism, rows over the data
    axis; 13 × 7 = 91 images, an odd split) against one process."""
    config = dict(zdim=8, epochs=2, batch_size=16, enc_features=(8, 16), dec_features=(16, 8))
    data = _data((13, 7))
    ranks = mesh_pool().run(dryrun.train_vae_rank, data, config)
    one = dryrun.train_vae(data, config, "cpu")
    for r in ranks:
        for ours, theirs in zip(r["history"], one["history"], strict=True):
            for k in ("loss", "recon_term", "kl_term", "mse", "val_loss", "val_mse"):
                np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)
    assert len({r["digest"] for r in ranks}) == 1


def test_dryrun_2d_branch(mesh_pool):
    """(vi) dryrun(4) on the 2 × 2 pool: one epoch against one process, the
    encoder's dense split at the default threshold, the JAX audit's budget,
    the same collectives per axis at 53 and 56 training rows."""
    out = dryrun.dryrun(4, device="cpu", pool=mesh_pool())
    assert out["mesh"] == (2, 2) and out["split"] == ["encoder.dense.weight"]
    assert out["n_train"] == [53, 56]
    assert 0 < out["max_bytes"] <= out["budget_bytes"]
    assert {"all_reduce", "model.gather", "model.all_reduce"} <= set(out["collectives"])
