"""The command without a card: it exits non-zero, names CUDA and prints no
result; in a tree without the program it fails too."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

CMD = ["benchmark/run.py", "--workload", "faces128_train", "--seed", "2147483999",
       "--seconds", "1", "--trace", "0"]


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_without_a_card_it_names_cuda_and_prints_nothing():
    _no_card()
    out = subprocess.run([sys.executable, *CMD], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "CUDA" in out.stderr and out.stdout == ""


def test_a_tree_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *CMD], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
