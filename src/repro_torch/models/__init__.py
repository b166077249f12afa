"""Model registry of the port: family -> builder (the mlp and hybrid
families so far; the other LM families come with ROADMAP.md queue 1
item 11b)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model
from repro_torch.models.mlp import build_mlp_model
from repro_torch.models.rglru import build_rglru_model

_BUILDERS = {"mlp": build_mlp_model, "hybrid": build_rglru_model}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _BUILDERS:
        raise NotImplementedError(
            f"no builder for family {cfg.family!r} in the port yet; the "
            f"other LM families come with ROADMAP.md queue 1 item 11b")
    return _BUILDERS[cfg.family](cfg)


__all__ = ["Model", "get_model"]
