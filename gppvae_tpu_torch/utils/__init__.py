"""Structured JSONL metrics, phase timers and the analytic FLOP count."""

from gppvae_tpu_torch.utils.metrics import MetricsLogger, NullLogger
from gppvae_tpu_torch.utils.timers import PhaseTimer

__all__ = ["MetricsLogger", "NullLogger", "PhaseTimer"]
