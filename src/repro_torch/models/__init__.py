"""Model registry of the port: family -> builder, for every family of
the reference (mlp, hybrid, dense, moe, ssm, vlm and audio)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model, make_grad_step, make_serve_step, make_train_step
from repro_torch.models.encdec import build_encdec_model
from repro_torch.models.mlp import build_mlp_model
from repro_torch.models.rglru import build_rglru_model
from repro_torch.models.sharding import UNSHARDED, ShardingPolicy
from repro_torch.models.transformer import build_decoder_model
from repro_torch.models.xlstm import build_xlstm_model

_BUILDERS = {"dense": build_decoder_model, "moe": build_decoder_model,
             "vlm": build_decoder_model, "audio": build_encdec_model,
             "hybrid": build_rglru_model, "ssm": build_xlstm_model,
             "mlp": build_mlp_model}


def get_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
              window: Optional[int] = None) -> Model:
    """The family's model of ``cfg`` under ``policy``: unsharded, or a
    pod/data replica policy (the federated round step's; every rank
    holds whole models). Model, fsdp, seq and ep2d axes raise."""
    if policy.mesh is not None and not policy.replicas_only:
        raise NotImplementedError(
            "mesh policies with model, fsdp, seq or ep2d axes come with "
            "ROADMAP.md queue 1 item 12b")
    if cfg.family not in _BUILDERS:
        raise NotImplementedError(f"no builder for family {cfg.family!r}")
    return dataclasses.replace(
        _BUILDERS[cfg.family](cfg, policy, window=window), policy=policy)


__all__ = ["Model", "get_model", "make_train_step", "make_grad_step",
           "make_serve_step", "ShardingPolicy", "UNSHARDED"]
