"""Minimal IDX-format (MNIST) file parser.

The port's copy of gppvae_tpu/data/mnist_idx.py.

Lets users point --data at a directory of the classic MNIST idx files
(train-images-idx3-ubyte[.gz] etc.) — the reference's rotated-MNIST builder
consumes the same raw files (SURVEY.md §2.1). No torchvision dependency.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_IMAGES = ("train-images-idx3-ubyte", "train-images.idx3-ubyte")
_LABELS = ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte")


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    with _open(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an IDX file (magic prefix {zero})")
        if dtype_code != 0x08:  # ubyte — all MNIST files
            raise ValueError(f"{path}: unsupported IDX dtype code 0x{dtype_code:02x}")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(shape)


def _find(dirname: str, stems: tuple[str, ...]) -> str:
    for stem in stems:
        for suffix in ("", ".gz"):
            p = os.path.join(dirname, stem + suffix)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(f"none of {stems} (+.gz) found in {dirname}")


def load_mnist_train(dirname: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (60000, 28, 28) float32 in [0,1], labels (60000,))."""
    images = read_idx(_find(dirname, _IMAGES)).astype(np.float32) / 255.0
    labels = read_idx(_find(dirname, _LABELS)).astype(np.int32)
    return images, labels
