"""Structured JSONL metrics (SURVEY.md §5: metrics/observability).

The port's copy of gppvae_tpu/utils/metrics.py: the same lines for the same
records.

The reference prints per-epoch loss terms to stdout; here every epoch emits
one JSON line to <outdir>/metrics.jsonl (losses, out-of-sample MSE,
sec/epoch, per-phase timings) *and* a human-readable stdout line — the
sec/epoch field is the headline benchmark metric (BASELINE.json:2).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any

import numpy as np


class MetricsLogger:
    def __init__(self, outdir: str | None, *, stream=None):
        self._stream = stream or sys.stdout
        self._fh = None
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            self._fh = open(os.path.join(outdir, "metrics.jsonl"), "a", buffering=1)

    def log(self, record: dict[str, Any]) -> None:
        rec = {k: _jsonable(v) for k, v in record.items()}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        parts = [f"{k}={_fmt(v)}" for k, v in rec.items()]
        print(" ".join(parts), file=self._stream, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class NullLogger(MetricsLogger):
    """Metrics sink that discards everything (benchmarks, validation)."""

    def __init__(self):
        super().__init__(None)

    def log(self, record) -> None:
        pass


def _jsonable(v):
    """numpy scalars and 0-d arrays or tensors as Python numbers."""
    if isinstance(v, np.generic):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return float(v.item())
    return v


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.5g}"
    return v
