"""Shared building blocks of the port's models (initializers so far)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (the LLaMA/PaLM convention): a
    standard normal cut to [-3, 3], times ``scale`` or 1/sqrt(fan_in).

    Drawn on the host from ``generator`` (a CPU ``torch.Generator``); it
    follows ``repro.models.common.dense_init`` in distribution, not in
    bits — ``jax.random`` is another stream.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return (x * std).to(dtype)
