"""Architecture config registry of the port.

``get_config(name)`` returns the exact published configuration. The
port carries the mlp family (the paper's own workload and its CI
stand-in), the hybrid family (``recurrentgemma-2b``, ROADMAP.md queue 1
item 11a), the dense transformer family (``stablelm-1.6b``,
``stablelm-3b``, ``granite-8b``, ``minitron-8b``, item 11b-1), the
moe family (``granite-moe-1b-a400m``, ``qwen3-moe-235b-a22b``, item
11b-2), the ssm family (``xlstm-1.3b``, item 11b-3), and the vlm
(``llava-next-mistral-7b``) and audio (``seamless-m4t-large-v2``)
families (item 11b-4): every architecture of the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.granite_8b import CONFIG as _granite_8b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite_moe_1b
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava_next
from repro_torch.configs.minitron_8b import CONFIG as _minitron_8b
from repro_torch.configs.paper_mlp import CONFIG as _paper_mlp, CONFIG_SMOKE as _mlp_smoke
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma_2b
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless_m4t
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm_1_6b
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm_3b
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm_1_3b

_REGISTRY = {c.name: c for c in (
    _paper_mlp, _mlp_smoke, _recurrentgemma_2b, _stablelm_1_6b,
    _stablelm_3b, _granite_8b, _minitron_8b, _granite_moe_1b, _qwen3_moe,
    _xlstm_1_3b, _llava_next, _seamless_m4t)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["ModelConfig", "MoEConfig", "get_config", "list_configs"]
