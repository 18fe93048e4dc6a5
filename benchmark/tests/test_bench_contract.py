"""Each configuration's reference module against the contract the harness
reads it by (harness/manifest.py): for the committed configurations, the
parameters' names, shapes and order, the epoch's FLOP and the initial
weights are those the harness read before it took them from the module;
for every configuration, the names and shapes are the program's own."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark.harness import program, weights
from benchmark.harness.manifest import Manifest
from benchmark.yardstick import flops

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
CHANNELS = {"rotated_digits": 1, "faces": 3}
SEED = 2**31 + 1234567

# vae_shapes as the harness drew them from when it read the configuration's
# fields by name (enc_features, dec_features, zdim), in draw order
SHAPES = {
    "digits_bf16": [
        ("encoder.convs.0.weight", (32, 1, 3, 3)), ("encoder.convs.0.bias", (32,)),
        ("encoder.convs.1.weight", (64, 32, 3, 3)), ("encoder.convs.1.bias", (64,)),
        ("encoder.convs.2.weight", (128, 64, 3, 3)), ("encoder.convs.2.bias", (128,)),
        ("encoder.dense.weight", (128, 2048)), ("encoder.dense.bias", (128,)),
        ("encoder.head_mu.weight", (16, 128)), ("encoder.head_mu.bias", (16,)),
        ("encoder.head_logvar.weight", (16, 128)), ("encoder.head_logvar.bias", (16,)),
        ("decoder.dense.weight", (2048, 16)), ("decoder.dense.bias", (2048,)),
        ("decoder.convs.0.weight", (128, 128, 3, 3)), ("decoder.convs.0.bias", (128,)),
        ("decoder.convs.1.weight", (64, 128, 3, 3)), ("decoder.convs.1.bias", (64,)),
        ("decoder.convs.2.weight", (32, 64, 3, 3)), ("decoder.convs.2.bias", (32,)),
        ("decoder.out.weight", (1, 32, 3, 3)), ("decoder.out.bias", (1,)),
    ],
    "faces128_f32": [
        ("encoder.convs.0.weight", (32, 3, 3, 3)), ("encoder.convs.0.bias", (32,)),
        ("encoder.convs.1.weight", (32, 32, 3, 3)), ("encoder.convs.1.bias", (32,)),
        ("encoder.convs.2.weight", (32, 32, 3, 3)), ("encoder.convs.2.bias", (32,)),
        ("encoder.convs.3.weight", (32, 32, 3, 3)), ("encoder.convs.3.bias", (32,)),
        ("encoder.convs.4.weight", (32, 32, 3, 3)), ("encoder.convs.4.bias", (32,)),
        ("encoder.dense.weight", (2048, 512)), ("encoder.dense.bias", (2048,)),
        ("encoder.head_mu.weight", (256, 2048)), ("encoder.head_mu.bias", (256,)),
        ("encoder.head_logvar.weight", (256, 2048)), ("encoder.head_logvar.bias", (256,)),
        ("decoder.dense.weight", (512, 256)), ("decoder.dense.bias", (512,)),
        ("decoder.convs.0.weight", (32, 32, 3, 3)), ("decoder.convs.0.bias", (32,)),
        ("decoder.convs.1.weight", (32, 32, 3, 3)), ("decoder.convs.1.bias", (32,)),
        ("decoder.convs.2.weight", (32, 32, 3, 3)), ("decoder.convs.2.bias", (32,)),
        ("decoder.convs.3.weight", (32, 32, 3, 3)), ("decoder.convs.3.bias", (32,)),
        ("decoder.convs.4.weight", (32, 32, 3, 3)), ("decoder.convs.4.bias", (32,)),
        ("decoder.out.weight", (3, 32, 3, 3)), ("decoder.out.bias", (3,)),
    ],
}
# the epoch's shapes at full size (n_train, n_heldout, rank) and
# gppvae_epoch_flops' total there, as train_mfu divided it
EPOCHS = {"digits_bf16": ((5700, 400, 56), 1_077_788_601_728),
          "faces128_f32": ((4119, 542, 576), 3_423_931_017_728)}
# sha256 of every initial tensor (name, then float32 bytes) that
# weights.make drew for SEED from _stub_grid
WEIGHTS_SHA256 = {
    "digits_bf16": "7a9a91bfb1342c66a4ad6d94a91174bb214b2017a0491a38b238e732d1c50648",
    "faces128_f32": "27c74bd47a3411ad0a6a01c1c845897a02c892b56cb27ec07b39125b61eb0621",
}


def _image_shape(cfg: dict) -> tuple:
    d = cfg["data"]
    return d["image_size"], d["image_size"], CHANNELS[d["kind"]]


def _stub_grid(cfg: dict) -> dict:
    """What weights.make reads of a grid, without its images."""
    d = cfg["data"]
    return {"images": torch.empty(0, *_image_shape(cfg)),
            "object_ids": np.arange(d["num_objects"]),
            "view_aux": np.linspace(0.0, 3.0, d["num_views"], dtype=np.float32)[:, None],
            "periodic_views": d["kind"] == "rotated_digits"}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_vae_shapes_are_as_the_harness_drew_them(name):
    cfg = Manifest().config(name)
    got = cfg["reference_module"].vae_shapes(cfg["model"], _image_shape(cfg))
    assert list(got.items()) == SHAPES[name]


@pytest.mark.parametrize("name", sorted(EPOCHS))
def test_the_epoch_flop_is_as_train_mfu_divided_it(name):
    cfg = Manifest().config(name)
    m, (n_train, n_heldout, rank), total = cfg["model"], *EPOCHS[name]
    shape = dict(zdim=m["zdim"], n_train=n_train, n_heldout=n_heldout,
                 batch_size=cfg["train"]["batch_size"], rank=rank)
    enc, dec = cfg["reference_module"].vae_flops(m, _image_shape(cfg))
    assert flops.epoch_flops(enc, dec, **shape)["total"] == total
    assert flops.gppvae_epoch_flops(
        image_shape=_image_shape(cfg), enc_features=m["enc_features"],
        dec_features=m["dec_features"], upsample=m["dec_upsample"], **shape)["total"] == total


@pytest.mark.parametrize("name", sorted(WEIGHTS_SHA256))
def test_weights_are_drawn_as_before(name):
    cfg = Manifest().config(name)
    vae, gp = weights.make(cfg["reference_module"], cfg["model"], cfg["train"],
                           _stub_grid(cfg), SEED, "cpu")
    h = hashlib.sha256()
    for k, t in {**vae, **gp}.items():
        h.update(k.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA256[name]


@pytest.mark.parametrize("name", [c["name"] for c in DOC["configs"]])
def test_vae_shapes_are_the_programs_parameters(name):
    """The reference names and shapes every parameter of the VAE that the
    program builds for the configuration (as harness/program.py's Server
    builds it), in the state_dict's order."""
    from gppvae_tpu_torch.models import VAE

    cfg = Manifest().config(name)
    m = cfg["model"]
    given = {"zdim": m["zdim"], "image_shape": _image_shape(cfg),
             "enc_features": tuple(m["enc_features"]), "dec_features": tuple(m["dec_features"]),
             "upsample": m["dec_upsample"]}
    model = VAE(**given, **program.vae_options(m, given))
    want = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    got = cfg["reference_module"].vae_shapes(m, _image_shape(cfg))
    assert [(k, tuple(s)) for k, s in got.items()] == want
