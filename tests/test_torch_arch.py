"""The VAE's architecture, one record in models/vae.py (`ARCH_DEFAULTS`,
`vae_from_record`, `add_arch_flags` / `arch_from_flags`), read back by every
reader of a run, on the CPU at a tiny size (6 objects × 4 views, 32²,
zdim 3, widths 4 and 8, one epoch).

Each of a run's readers rebuilds the model its trainer trained: load_final
from the run's config.json, `generate` from the same file (the model it
folds for --export_server) and `serve --state` from the .srv meta
(`serving._model_from_meta`). They build the same state_dict keys and
shapes, holding the run's weights, in the same layout and decoder lowering;
generate and serve in the run's compute dtype, load_final in float32 after
a float32 polish tail. A record written before `vae_layout`,
`dec_upsample` and `compute_dtype` existed reads as 'port', 'resize' and
float32 at every reader. The three CLIs parse the architecture flags to
the values they gave before the flags had one home.
"""

import contextlib
import io
import itertools
import json

import pytest
import torch

from gppvae_tpu_torch.eval import generate, serving
from gppvae_tpu_torch.models import ARCH_DEFAULTS, LAYOUTS, UPSAMPLES
from gppvae_tpu_torch.train import train_gppvae, train_vae
from _one_thread import one_thread  # noqa: F401

TINY = ["--data", "synthetic", "--num_objects", "6", "--num_views", "4", "--zdim", "3",
        "--bs", "8", "--enc_features", "4,8", "--dec_features", "8,4", "--seed", "7",
        "--device", "cpu", "--xdim", "2", "--view_freqs", "1", "--epochs", "1",
        "--panel_every", "0"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the six fields as the CLIs give them by default, and with FLAGS
DEFAULTS = {"zdim": 16, "enc_features": (32, 64, 128), "dec_features": (128, 64, 32),
            "dec_upsample": "resize", "compute_dtype": "float32", "vae_layout": "port"}
FLAGS = ["--zdim", "5", "--dtype", "bfloat16", "--dec_upsample", "subpixel",
         "--vae_layout", "facevae", "--enc_features", "4,8", "--dec_features", "8,4"]
PARSED = {"zdim": 5, "enc_features": (4, 8), "dec_features": (8, 4),
          "dec_upsample": "subpixel", "compute_dtype": "bfloat16", "vae_layout": "facevae"}


def _export(run_dir, monkeypatch):
    """`generate --export_server` of the run in run_dir: (the model generate
    folded, the .srv path)."""
    folded = []
    build = generate.build_server_state
    monkeypatch.setattr(generate, "build_server_state",
                        lambda model, *a, **k: folded.append(model) or build(model, *a, **k))
    srv = str(run_dir / "m.srv")
    with contextlib.redirect_stdout(io.StringIO()):
        generate.main(["--state", str(run_dir / "final_params.pt"), "--device", "cpu",
                       "--export_server", srv])
    return folded[0], srv


def _readers(run_dir, srv, folded) -> dict:
    state, meta = serving.load_server_state(srv)
    return {"load_final": train_gppvae.load_final(str(run_dir)).model, "generate": folded,
            "serve": serving._model_from_meta(meta, state.vae_params, "cpu")}


def _strip(path, keys) -> None:
    record = json.loads(path.read_text())
    path.write_text(json.dumps({k: v for k, v in record.items() if k not in keys}))


@pytest.mark.parametrize("layout, upsample, dtype",
                         list(itertools.product(LAYOUTS, UPSAMPLES, DTYPES)))
def test_every_reader_rebuilds_the_recorded_vae(tmp_path, monkeypatch, layout, upsample, dtype):
    polish = ["--polish_epochs", "1"] if dtype == "bfloat16" else []
    want = train_gppvae.main([*TINY, "--vae_layout", layout, "--dec_upsample", upsample,
                              "--dtype", dtype, *polish, "--outdir", str(tmp_path)]
                             ).model.state_dict()
    readers = _readers(tmp_path, *reversed(_export(tmp_path, monkeypatch)))
    # load_final rebuilds where the trainer ended, in float32 after the polish
    # tail; generate and serve compute in the run's dtype
    dtypes = {"load_final": torch.float32, "generate": DTYPES[dtype], "serve": DTYPES[dtype]}
    for name, model in readers.items():
        got = model.state_dict()
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}, name
        assert all(torch.equal(got[k], v) for k, v in want.items()), name
        assert (model.vae_layout, model.decoder.vae_layout, model.decoder.upsample) == (
            layout, layout, upsample), name
        assert (model.dtype, model.decoder.dtype) == (dtypes[name], dtypes[name]), name


def test_a_record_older_than_the_options_reads_the_defaults(tmp_path, monkeypatch):
    """A bfloat16 subpixel run whose records lack the three fields: every
    reader builds 'port', 'resize' and float32."""
    train_gppvae.main([*TINY, "--dtype", "bfloat16", "--dec_upsample", "subpixel",
                       "--outdir", str(tmp_path)])
    old = ("vae_layout", "dec_upsample", "compute_dtype")
    _strip(tmp_path / "config.json", old)
    folded, srv = _export(tmp_path, monkeypatch)
    _strip(tmp_path / "m.srv.meta.json", old)
    for name, model in _readers(tmp_path, srv, folded).items():
        assert (model.vae_layout, model.decoder.upsample, model.dtype) == (
            "port", "resize", torch.float32), name


class _Parsed(Exception):
    """Raised in place of a run, holding what the CLI parsed."""


@pytest.mark.parametrize("cli", ["train-vae", "train-gppvae", "generate"])
def test_the_clis_parse_the_architecture_flags(tmp_path, monkeypatch, cli):
    assert {k: ARCH_DEFAULTS[k] for k in DEFAULTS} == DEFAULTS

    def parsed(main, argv) -> dict:
        with pytest.raises(_Parsed) as e:
            main(argv)
        got = e.value.args[0]  # generate hands on config.json's lists as read
        return {k: tuple(got[k]) if isinstance(got[k], list) else got[k] for k in DEFAULTS}

    def stop(*args, **kw):
        raise _Parsed(kw.get("config") or kw)

    if cli == "generate":
        # the architecture a run's config.json records, --zdim overriding;
        # the defaults without a config.json
        monkeypatch.setattr(generate, "build_dataset_from_flag", lambda *a, **k: None)
        monkeypatch.setattr(generate, "generate_heldout", stop)
        for run in ("recorded", "bare"):
            (tmp_path / run).mkdir()
            torch.save({}, tmp_path / run / "final_params.pt")
        (tmp_path / "recorded" / "config.json").write_text(json.dumps(PARSED))
        argv = ["--state", str(tmp_path / "recorded" / "final_params.pt"), "--device", "cpu"]
        assert parsed(generate.main, argv) == PARSED
        assert parsed(generate.main, [*argv, "--zdim", "9"]) == {**PARSED, "zdim": 9}
        bare = ["--state", str(tmp_path / "bare" / "final_params.pt"), "--device", "cpu"]
        assert parsed(generate.main, bare) == DEFAULTS
        return
    module, fn = {"train-vae": (train_vae, "train_vae"),
                  "train-gppvae": (train_gppvae, "train_gppvae")}[cli]
    monkeypatch.setattr(module, "build_dataset_from_flag", lambda *a, **k: None)
    monkeypatch.setattr(module, fn, lambda ds, config, **kw: stop(config=vars(config)))
    argv = ["--device", "cpu"]
    assert parsed(module.main, argv) == DEFAULTS
    assert parsed(module.main, [*argv, *FLAGS]) == PARSED
