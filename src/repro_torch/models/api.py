"""The Model interface of the port.

A ``Model`` is a bundle of plain functions over a plain-dict param tree
in the reference's layout (``repro.models.api.Model``): the FL layer and
the serving scheduler program against this interface only. The
reference's sharding fields come with the multi-device paths (ROADMAP.md
queue 1 item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class Model:
    config: ModelConfig
    # (generator, device) -> params, drawn on the generator's device; a
    # CPU torch.Generator gives the same params on every device
    init: Callable[[torch.Generator, Any], Any]
    # (params, batch) -> (loss, metrics); with a leading client dim on
    # the params and the batch, the loss and metrics keep that dim
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], Any]
    # (params, batch) -> (last_logits, decode_state)
    prefill_fn: Optional[Callable] = None
    # (params, state, batch) -> (logits, state)
    decode_fn: Optional[Callable] = None
    # (batch_size, cache_len, device) -> a zero decode state
    init_decode_state: Optional[Callable] = None
