"""Serving substrate: request scheduling over the port's prefill/decode."""
from repro_torch.serving.scheduler import Request, WaveScheduler, WaveStats

__all__ = ["Request", "WaveScheduler", "WaveStats"]
