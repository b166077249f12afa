"""The Model interface of the port.

A ``Model`` is a bundle of plain functions over a plain-dict param tree
in the reference's layout (``repro.models.api.Model``): the FL layer
programs against this interface only. The decode and sharding fields of
the reference come with the LM families (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class Model:
    config: ModelConfig
    # (generator, device) -> params; the generator is a CPU
    # torch.Generator, so one seed gives the same params on every device
    init: Callable[[torch.Generator, Any], Any]
    # (params, batch) -> (loss, metrics); with a leading client dim on
    # the params and the batch, the loss and metrics keep that dim
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], Any]
