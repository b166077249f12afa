"""Model registry of the port: family -> builder (the mlp family so far;
the LM families come with ROADMAP.md queue 1 item 11)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model
from repro_torch.models.mlp import build_mlp_model

_BUILDERS = {"mlp": build_mlp_model}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _BUILDERS:
        raise NotImplementedError(
            f"no builder for family {cfg.family!r} in the port yet; the "
            f"LM families come with ROADMAP.md queue 1 item 11")
    return _BUILDERS[cfg.family](cfg)


__all__ = ["Model", "get_model"]
