"""Wall-clock phase timers for the epoch loop.

Counterpart of gppvae_tpu/utils/timers.py: phases A/B/C of the GPPVAE epoch
are timed individually, and sec/epoch is their sum. CUDA work is
asynchronous, so each phase starts and ends with a device synchronize (the
JAX package blocks on its results at the phase boundaries): the numbers mean
device time, not enqueue time. On the CPU the synchronize is a no-op.
"""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Seconds per named phase, accumulated in `totals` until `reset`."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def reset(self) -> dict[str, float]:
        out, self.totals = self.totals, {}
        return out
