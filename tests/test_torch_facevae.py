"""FaceVAE (`vae_layout="facevae"`, models/vae.py) against its plain float64
reference (benchmark/reference/facevae.py) on the CPU at 32×32×3, three
stages of 8 channels, zdim 8, on seeded random weights drawn under the
reference's `vae_shapes` names; the layout through the trainers, resume and
serving; and the `vae.conv3x3` counter. Nothing of the benchmark's harness is
imported: the comparisons are written here.

Tolerances: the program's VAE run in float64 hands μ, log σ² and the logits
back as float32 (models/vae.py), so it differs from the float64 reference by
float32's rounding of those outputs, 2⁻²⁴ ≈ 6e-8 of each value: 1e-6 of a
norm leaves room for the sums over many such roundings and nothing more.
The trainer computes in float32 where the reference computes in float64:
Phase B's NLL and the epoch's mean loss over its three steps agree to 1e-5
(a sum over 3,072 pixels a row in float32; 5e-9 and 9e-8 measured), and
each parameter's change after the three Adam steps to 1e-4 of its norm
(4.4e-5 measured), over the parameters whose reference gradient is at least
a thousandth of the median (the others move by round-off under Adam's
normalisation). The view features W are held by the norm of their change,
as the benchmark's update_gap holds them, to 1e-2 (1.8e-6 measured): their
entries whose gradient is round-off move by ±lr either way under Adam
(PERF.md, Findings).
"""

import dataclasses
import json
import math

import pytest
import torch

from benchmark.reference import facevae, gppvae
from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.eval import generate, serving
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.train import train_gppvae, train_vae
from gppvae_tpu_torch.utils import timers
from _one_thread import one_thread  # noqa: F401

SHAPE = (32, 32, 3)
MODEL = {"zdim": 8, "enc_features": [8, 8, 8], "dec_features": [8, 8, 8],
         "obj_feature_dim": 3, "view_feature_dim": 5, "dec_upsample": "resize",
         "compute_dtype": "float32", "vae_layout": "facevae"}
TRAIN = {"lr_vae": 2e-4, "lr_gp": 1e-3, "sigma_y": 0.1, "init_v_sig": 1.0,
         "init_v_noise": 0.5, "clip_grad_norm": 1e5, "sat_penalty": 1.0}
CLI = ["--data", "faces", "--num_objects", "6", "--num_views", "4", "--image_size", "32",
       "--zdim", "8", "--bs", "8", "--enc_features", "8,8,8", "--dec_features", "8,8,8",
       "--seed", "3", "--device", "cpu"]
RTOL_F32_OUT = 1e-6


def _rel(got, want) -> float:
    """‖got − want‖ / ‖want‖ in float64."""
    got, want = got.detach().double(), want.detach().double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _weights(layout_shapes: dict, seed: int = 19) -> dict:
    """Seeded random weights of the reference's names: LeCun-scaled
    weights, small nonzero biases (so that a bias's gradient is tested)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in layout_shapes.items():
        t = torch.randn(shape, generator=g, dtype=torch.float64)
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        out[name] = t * (0.1 if name.endswith(".bias") else 1.0 / math.sqrt(fan_in))
    return out


def _program(layout: str, params: dict, dtype=torch.float64) -> VAE:
    model = VAE(MODEL["zdim"], SHAPE, tuple(MODEL["enc_features"]),
                tuple(MODEL["dec_features"]), dtype=dtype, vae_layout=layout).to(dtype)
    model.load_state_dict(params)
    return model


def test_state_dict_is_the_references_names_shapes_and_order():
    model = VAE(MODEL["zdim"], SHAPE, (8, 8, 8), (8, 8, 8), vae_layout="facevae")
    want = [(k, tuple(s)) for k, s in facevae.vae_shapes(MODEL, SHAPE).items()]
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == want
    assert not any(k.startswith(("encoder.dense", "decoder.out")) for k, _ in want)
    strides = [model.encoder.convs[i].stride for i in range(6)]
    assert strides == [(1, 1), (2, 2)] * 3
    assert all(c.padding == (1, 1) for c in [*model.encoder.convs, *model.decoder.convs])
    # the last stage maps to the image's channels, upstream's Conv2dCellUp(nf, colors)
    assert [tuple(c.weight.shape[:2]) for c in model.decoder.convs[-2:]] == [(3, 8), (3, 3)]


def _loss(mu, logvar, logits, c):
    """A scalar that weighs every output differently."""
    return (torch.sum(c[0][: mu.numel()].reshape(mu.shape) * mu)
            + torch.sum(c[1][: logvar.numel()].reshape(logvar.shape) * torch.exp(0.5 * logvar))
            + torch.sum(c[2][: logits.numel()].reshape(logits.shape) * torch.sigmoid(logits)))


def test_encode_decode_and_gradients_match_the_reference():
    params = _weights(facevae.vae_shapes(MODEL, SHAPE))
    g = torch.Generator().manual_seed(5)
    y = torch.rand(6, *SHAPE, generator=g, dtype=torch.float64)
    c = [torch.randn(6 * math.prod(SHAPE), generator=g, dtype=torch.float64) for _ in range(3)]
    a = gppvae.Arith("exact")

    model = _program("facevae", params)
    mu, logvar = model.encode(y)
    logits = model.decode(mu)
    _loss(mu.double(), logvar.double(), logits.double(), c).backward()
    got = {k: p.grad for k, p in model.named_parameters()}

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    rmu, rlogvar = facevae.encode(leaves, y, a, 3)
    rlogits = facevae.decode(leaves, rmu, a, SHAPE, MODEL["dec_features"])
    want = dict(zip(leaves, torch.autograd.grad(_loss(rmu, rlogvar, rlogits, c),
                                                list(leaves.values()))))

    for p, r in ((mu, rmu), (logvar, rlogvar), (logits, rlogits)):
        assert _rel(p, r) < RTOL_F32_OUT
    for k in want:
        assert _rel(got[k], want[k]) < RTOL_F32_OUT, k


def test_the_port_layout_is_the_default_and_unchanged():
    """'port' is the default, builds the parameters gppvae.py names, draws the
    same init, and computes gppvae.py's function."""
    default = VAE(MODEL["zdim"], SHAPE, (8, 8, 8), (8, 8, 8), key=4)
    port = VAE(MODEL["zdim"], SHAPE, (8, 8, 8), (8, 8, 8), key=4, vae_layout="port")
    assert default.vae_layout == "port"
    sd, sp = default.state_dict(), port.state_dict()
    assert list(sd) == list(sp) and all(torch.equal(sd[k], sp[k]) for k in sd)
    assert [(k, tuple(v.shape)) for k, v in sd.items()] == [
        (k, tuple(s)) for k, s in gppvae.vae_shapes(MODEL, SHAPE).items()]

    params = _weights(gppvae.vae_shapes(MODEL, SHAPE))
    y = torch.rand(4, *SHAPE, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    model = _program("port", params)
    with torch.no_grad():
        mu, logvar = model.encode(y)
        rmu, rlogvar = gppvae.encode(params, y, gppvae.Arith("exact"), 3)
        logits = model.decode(mu)
        rlogits = gppvae.decode(params, mu.double(), gppvae.Arith("exact"), SHAPE, [8, 8, 8])
    for p, r in ((mu, rmu), (logvar, rlogvar), (logits, rlogits)):
        assert _rel(p, r) < RTOL_F32_OUT
    with pytest.raises(ValueError, match="vae_layout"):
        VAE(MODEL["zdim"], SHAPE, vae_layout="upstream")


def _draws(n: int, bs: int, zdim: int, seed: int):
    """draws(epoch) → (batches, weights, ε) of one epoch: a permutation of
    the n rows padded to whole batches with weight 0, and normal ε."""
    nb = -(-n // bs)

    def draws(epoch: int):
        g = torch.Generator().manual_seed(seed + epoch)
        perm = torch.randperm(n, generator=g)
        perm = torch.cat([perm, perm[:nb * bs - n]])
        weights = torch.ones(nb * bs)
        weights[n:] = 0.0
        return (perm.reshape(nb, bs), weights.reshape(nb, bs),
                torch.randn(nb, bs, zdim, generator=g))

    return draws


def test_one_joint_epoch_agrees_with_the_reference():
    """train_gppvae's first epoch of three steps, from weights drawn under
    the reference's names, against facevae.GPPVAE on the same draws:
    Phase A's NLL, the epoch's mean loss and each parameter's change."""
    ds = build_dataset_from_flag("faces", 8, 5, seed=2, image_size=32)
    n = len(ds.train_idx)
    bs = -(-n // 3)
    config = train_gppvae.GPPVAETrainConfig(
        mode="joint", zdim=MODEL["zdim"], enc_features=tuple(MODEL["enc_features"]),
        dec_features=tuple(MODEL["dec_features"]), obj_feature_dim=MODEL["obj_feature_dim"],
        view_feature_dim=MODEL["view_feature_dim"], batch_size=bs, epochs=1,
        vae_layout="facevae", **TRAIN)
    vae0 = {k: v.float() for k, v in _weights(facevae.vae_shapes(MODEL, SHAPE)).items()}
    g = torch.Generator().manual_seed(8)
    W = torch.randn(ds.num_views, MODEL["view_feature_dim"], generator=g)
    gp0 = {"X": torch.randn(ds.num_objects, MODEL["obj_feature_dim"], generator=g) / 3 ** 0.5,
           "W": W / torch.linalg.norm(W, dim=1, keepdim=True),
           "log_vs": torch.zeros(1), "log_vn": torch.tensor(math.log(0.5))}
    draws = _draws(n, bs, MODEL["zdim"], 19)
    res = train_gppvae.train_gppvae(
        ds, config, device="cpu", draws=draws, log=_Quiet(),
        init_params={"vae": vae0, "gp": {k: v.numpy() for k, v in gp0.items()}})

    ref = facevae.GPPVAE({**MODEL, **TRAIN}, SHAPE, vae0, gp0, "exact")
    tr = ds.train_idx
    images = torch.from_numpy(ds.images[tr])
    d = torch.as_tensor(ds.object_ids[tr], dtype=torch.int64)
    q = torch.as_tensor(ds.view_ids[tr], dtype=torch.int64)
    coeffs = ref.taylor(ref.means(images), d, q)
    batches, w, eps = draws(0)
    assert batches.shape[0] == 3
    out = ref.follow(coeffs, images, d, q, list(zip(batches, w, eps)), n, 3)

    got = res.history[0]
    assert abs(got["gp_nll_full"] - float(coeffs["value"]) / n) < 1e-5 * abs(got["gp_nll_full"])
    want_loss = sum(out["losses"]) / 3
    assert abs(got["loss"] - want_loss) < 1e-5 * abs(want_loss)
    start = {**vae0, **{f"gp.{k}": v for k, v in gp0.items()}}
    end = {**res.model.state_dict(), **{f"gp.{k}": v for k, v in res.gp_params.items()}}
    norms = {k: float(torch.linalg.norm(v)) for k, v in out["grads"].items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    moved = [k for k, v in norms.items() if v >= floor]
    assert len(moved) >= len(norms) - 4
    for k in moved:
        change, want = (end[k] - start[k]).detach(), out["change"][k]
        if k == "gp.W":
            gap = abs(float(torch.linalg.norm(change)) - float(torch.linalg.norm(want)))
            assert gap < 1e-2 * float(torch.linalg.norm(want))
        else:
            assert _rel(change, want) < 1e-4, k


class _Quiet:
    def log(self, rec):
        pass


@pytest.mark.parametrize("layout,per_forward", [("facevae", (6, 6)), ("port", (3, 4))])
def test_the_conv_counter_counts_each_half_once(layout, per_forward):
    model = VAE(MODEL["zdim"], SHAPE, (8, 8, 8), (8, 8, 8), vae_layout=layout)
    y = torch.rand(2, *SHAPE)
    before = timers.TRACER.counts.get("vae.conv3x3", 0)
    mu, _ = model.encode(y)
    assert timers.TRACER.counts["vae.conv3x3"] - before == per_forward[0]
    model.decode(mu)
    assert timers.TRACER.counts["vae.conv3x3"] - before == sum(per_forward)


@pytest.fixture(scope="module")
def facevae_run(tmp_path_factory):
    """train_vae → train_gppvae → generate --export_server, all FaceVAE."""
    root = tmp_path_factory.mktemp("facevae")
    train_vae.main([*CLI, "--vae_layout", "facevae", "--epochs", "1",
                    "--outdir", str(root / "vae")])
    weights = str(root / "vae" / "vae_weights.pt")
    res = train_gppvae.main([*CLI, "--vae_layout", "facevae", "--epochs", "1",
                             "--xdim", "3", "--view_feature_dim", "3", "--vae_weights", weights,
                             "--outdir", str(root / "gp")])
    srv = str(root / "m.srv")
    generate.main(["--state", str(root / "gp" / "final_params.pt"), "--device", "cpu",
                   "--export_server", srv])
    return {"root": root, "weights": weights, "result": res, "srv": srv}


def test_the_layout_goes_through_train_vae_train_gppvae_and_serve(facevae_run, capsys):
    run = facevae_run
    assert run["result"].model.vae_layout == "facevae"
    saved = json.loads((run["root"] / "gp" / "config.json").read_text())
    assert saved["vae_layout"] == "facevae"
    state, meta = serving.load_server_state(run["srv"])
    assert meta["vae_layout"] == "facevae"
    model = serving._model_from_meta(meta, state.vae_params, "cpu")
    assert model.vae_layout == "facevae" and len(model.encoder.convs) == 6
    capsys.readouterr()
    serving.main(["--state", run["srv"], "--device", "cpu", "--requests", "0:1,2:3",
                  "--outdir", str(run["root"] / "serve")])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert lines and lines[-1]["n_requests"] == 2

    with pytest.raises(ValueError, match="vae_layout"):
        train_gppvae.main([*CLI, "--epochs", "1", "--xdim", "3", "--view_feature_dim", "3",
                           "--vae_weights", run["weights"],
                           "--outdir", str(run["root"] / "port")])


def test_a_resume_under_the_other_layout_is_refused_by_name(facevae_run, tmp_path):
    gp_dir = facevae_run["root"] / "gp"
    flags = [*CLI, "--epochs", "2", "--xdim", "3", "--view_feature_dim", "3",
             "--resume", str(gp_dir / "final_state"), "--outdir", str(tmp_path / "r")]
    with pytest.raises(ValueError, match="vae_layout: the state has 'facevae', this run 'port'"):
        train_gppvae.main(flags)
    res = train_gppvae.main([*flags, "--vae_layout", "facevae"])
    assert len(res.history) == 1 and res.model.vae_layout == "facevae"


def test_a_state_from_before_the_layout_resumes_as_port(tmp_path):
    """A train state whose `shape` has no vae_layout was written under 'port'."""
    from gppvae_tpu_torch.checkpoint import load_tree, save_tree

    base = [*CLI, "--xdim", "3", "--view_feature_dim", "3"]
    train_gppvae.main([*base, "--epochs", "1", "--outdir", str(tmp_path / "a")])
    state = load_tree(str(tmp_path / "a" / "final_state"))
    del state["shape"]["vae_layout"]
    save_tree(str(tmp_path / "old_state"), state)
    res = train_gppvae.main([*base, "--epochs", "2", "--resume", str(tmp_path / "old_state"),
                             "--outdir", str(tmp_path / "b")])
    assert len(res.history) == 1
    with pytest.raises(ValueError, match="vae_layout: the state has 'port', this run 'facevae'"):
        train_gppvae.main([*base, "--epochs", "2", "--vae_layout", "facevae",
                           "--resume", str(tmp_path / "old_state"),
                           "--outdir", str(tmp_path / "c")])


def test_the_train_config_records_the_layout():
    fields = {f.name: f.default for f in dataclasses.fields(train_gppvae.GPPVAETrainConfig)}
    assert fields["vae_layout"] == "port" and "vae_layout" in train_gppvae._SHAPE_FIELDS
    fields = {f.name: f.default for f in dataclasses.fields(train_vae.VAETrainConfig)}
    assert fields["vae_layout"] == "port"
