"""The port's own data modules against the JAX package's.

gppvae_tpu_torch.data / .config / .utils are copies, so that the port
imports nothing of gppvae_tpu; these tests hold each copy to its original on
the same arguments. Images agree to atol 1e-5: the JAX package rotates with
its native C++ library where that is built, the port with numpy alone, and
tests/test_native.py holds those two to the same bound. Everything else
(ids, view auxiliaries, splits, names, JSONL lines) is equal.
"""

import io
import json

import numpy as np
import pytest
import torch

from gppvae_tpu.config.datasets import build_dataset_from_flag as jax_build
from gppvae_tpu.data.transforms import rotate_bilinear as jax_rotate
from gppvae_tpu.utils.metrics import MetricsLogger as JaxLogger
from gppvae_tpu_torch.config import build_dataset_from_flag
from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.data.transforms import rotate_bilinear
from gppvae_tpu_torch.utils import MetricsLogger, NullLogger

FIELDS = ("object_ids", "view_ids", "view_aux", "train_idx", "val_idx", "heldout_idx")


def _assert_same(ours, theirs):
    assert ours.images.shape == theirs.images.shape
    assert ours.images.dtype == theirs.images.dtype == np.float32
    np.testing.assert_allclose(ours.images, theirs.images, rtol=0, atol=1e-5)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k), err_msg=k)
        assert getattr(ours, k).dtype == getattr(theirs, k).dtype, k
    assert ours.name == theirs.name
    assert ours.periodic_views == theirs.periodic_views
    assert (ours.num_objects, ours.num_views, ours.image_shape) == (
        theirs.num_objects, theirs.num_views, theirs.image_shape)


@pytest.mark.parametrize("flag,p,q,size", [
    ("synthetic", 10, 8, None),
    ("synthetic", 12, 6, 16),   # smaller than the glyphs: the resize branch
    ("sklearn", 10, 8, None),
    ("faces", 6, 5, None),      # 64²
    ("faces", 4, 3, 128),
])
def test_dataset_from_flag_matches_jax(flag, p, q, size):
    ours = build_dataset_from_flag(flag, p, q, seed=3, image_size=size)
    theirs = jax_build(flag, p, q, seed=3, image_size=size)
    assert isinstance(ours, GridDataset)
    _assert_same(ours, theirs)


def test_npz_round_trip_matches_jax(tmp_path):
    ds = build_dataset_from_flag("synthetic", 8, 6, seed=1)
    path = tmp_path / "grid.npz"
    ds.save_npz(path)
    ours = build_dataset_from_flag(f"npz:{path}", 0, 0, seed=0)
    theirs = jax_build(f"npz:{path}", 0, 0, seed=0)
    _assert_same(ours, theirs)
    np.testing.assert_array_equal(ours.images, ds.images)
    with pytest.raises(ValueError, match="rebuild it at that size"):
        build_dataset_from_flag(f"npz:{path}", 0, 0, seed=0, image_size=64)


def test_rotate_bilinear_matches_jax_numpy_path():
    rng = np.random.default_rng(0)
    images = rng.random((5, 17, 13)).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, 5).astype(np.float32)
    np.testing.assert_array_equal(rotate_bilinear(images, angles),
                                  jax_rotate(images, angles, use_native=False))


def test_metrics_logger_writes_the_jax_lines(tmp_path):
    records = [
        {"driver": "train_gppvae[joint]", "epoch": 0, "loss": 1.25, "oos_mse": 0.0301},
        {"epoch": np.int64(1), "loss": np.float32(0.5), "zero_d": np.array(2.0),
         "tensor": torch.tensor(3.5), "name": "x", "items": [1, 2]},
    ]
    out = {}
    for name, cls in (("ours", MetricsLogger), ("theirs", JaxLogger)):
        stream = io.StringIO()
        log = cls(str(tmp_path / name), stream=stream)
        for r in records:
            log.log(r)
        log.close()
        out[name] = ((tmp_path / name / "metrics.jsonl").read_text(), stream.getvalue())
    assert out["ours"] == out["theirs"]
    assert [json.loads(line)["epoch"] for line in out["ours"][0].splitlines()] == [0, 1]
    NullLogger().log(records[0])  # writes nothing, needs no outdir
