"""Structured JSONL metrics."""

from gppvae_tpu_torch.utils.metrics import MetricsLogger, NullLogger

__all__ = ["MetricsLogger", "NullLogger"]
