"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's tree
(the same files, at sizes a CPU runs in seconds), and the card for the tests
that need it."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_MODEL = {"zdim": 4, "enc_features": [8, 16], "dec_features": [16, 8],
              "obj_feature_dim": 3, "view_num_freqs": 1, "view_feature_dim": None}
TINY_DATA = {"rotated_digits": {"num_objects": 12, "num_views": 8, "image_size": 32},
             "faces": {"num_objects": 12, "num_views": 5, "image_size": 16}}
TINY_MIX = {"trace_epochs": 1, "trace_requests": 5, "objects_per_request": [1, 4],
            "check_share": 0.3, "max_checked": 8}


def tiny_tree(tmp: Path, limits: dict | None = None):
    """A copy of BENCHMARK.json, the benchmark's data files, metrics and
    reference modules under `tmp`, every configuration cut to a tiny size and
    every mix to a short slice; the limits are the committed ones unless
    `limits` replaces them."""
    from benchmark.harness.manifest import Manifest

    bench = tmp / "benchmark"
    for d in ("metrics", "limits", "reference"):
        shutil.copytree(ROOT / "benchmark" / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic"):
        (bench / d).mkdir(parents=True)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["data"].update(TINY_DATA[cfg["data"]["kind"]])
        cfg["model"].update(TINY_MODEL)
        cfg["train"].update(batch_size=16)
        c["file"] = f"benchmark/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for f in (ROOT / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
        (bench / "traffic" / f.name).write_text(json.dumps(mix))
    for cell, values in (limits or {}).items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(values))
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return Manifest(tmp / "BENCHMARK.json", bench)


@pytest.fixture
def tiny(tmp_path):
    return tiny_tree(tmp_path)


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
