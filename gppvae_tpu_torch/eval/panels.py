"""Image panels as PNG files.

Counterpart of gppvae_tpu/eval/panels.py, with the same grid layout. The
PNG is written here with zlib and struct (8-bit grey or RGB, no filter), so
that the port needs no imaging library.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path: str, arr: np.ndarray) -> None:
    """arr: (H, W) grey or (H, W, 3) RGB uint8 → an 8-bit PNG at `path`."""
    H, W = arr.shape[:2]
    color_type = 0 if arr.ndim == 2 else 2
    rows = arr.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)  # filter 0 per row
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_panel(path: str, rows: list[np.ndarray], *, pad: int = 2) -> None:
    """rows: list of (B, H, W, C) arrays in [0,1]; one grid row each, cut to
    the shortest row."""
    rows = [np.asarray(r) for r in rows]
    B = min(r.shape[0] for r in rows)
    H, W, C = rows[0].shape[1:]
    grid = np.ones(
        (len(rows) * (H + pad) + pad, B * (W + pad) + pad, 3 if C == 3 else 1),
        dtype=np.float32,
    )
    for i, row in enumerate(rows):
        for j in range(B):
            y0 = pad + i * (H + pad)
            x0 = pad + j * (W + pad)
            grid[y0: y0 + H, x0: x0 + W] = np.clip(row[j], 0.0, 1.0)
    arr = (grid * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_png(path, arr)
