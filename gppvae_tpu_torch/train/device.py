"""Device selection, compute dtype and float32 precision for the trainers."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def resolve_device(name: str) -> torch.device:
    """torch.device(name); raises if it names CUDA and there is none (CPU
    runs ask for it with `--device cpu`)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} but CUDA is not available; pass --device cpu "
            "to run on the CPU"
        )
    return device


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The VAE's compute dtype for a --dtype value."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}; want one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def set_float32_precision(compute_dtype_name: str) -> None:
    """Full float32 for matmuls and convolutions, whatever the VAE's
    compute dtype: the GP path, the kernels and a bfloat16 run's float32
    polish tail stay float32 (cuDNN's TF32 default would otherwise change
    the f32 convolutions)."""
    compute_dtype(compute_dtype_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class PhaseTimer:
    """Wall-clock seconds per named phase, each ended by a device sync."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
