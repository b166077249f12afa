"""Model registry of the port: family -> builder, for every family of
the reference (mlp, hybrid, dense, moe, ssm, vlm and audio)."""
from __future__ import annotations

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
    if policy.mesh is not None:
        raise NotImplementedError(
            "mesh sharding policies come with ROADMAP.md queue 1 item 12")
    if cfg.family not in _BUILDERS:
        raise NotImplementedError(f"no builder for family {cfg.family!r}")
    return _BUILDERS[cfg.family](cfg, policy, window=window)


__all__ = ["Model", "get_model", "make_train_step", "make_grad_step",
           "make_serve_step", "ShardingPolicy", "UNSHARDED"]
