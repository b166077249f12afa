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
from repro_torch.models.sharding import UNSHARDED, ShardingPolicy, check_runnable, make_policy
from repro_torch.models.transformer import build_decoder_model
from repro_torch.models.xlstm import build_xlstm_model

_BUILDERS = {"dense": build_decoder_model, "moe": build_decoder_model,
             "vlm": build_decoder_model, "audio": build_encdec_model,
             "hybrid": build_rglru_model, "ssm": build_xlstm_model,
             "mlp": build_mlp_model}


def get_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
              window: Optional[int] = None) -> Model:
    """The family's model of ``cfg`` under ``policy``, its spec rules
    the reference's for any policy. Its functions run unsharded; under
    a pod/data replica policy (the federated round step's: every rank
    holds whole models); or, for the dense, vlm, hybrid and audio
    families, over model, seq, fsdp and batch axes (each rank holds its
    shards). Under any other layout they raise NotImplementedError
    naming their ROADMAP.md item (``sharding.check_runnable``), while
    ``param_pspecs`` and ``state_pspecs`` still answer."""
    if cfg.family not in _BUILDERS:
        raise KeyError(f"no builder for family {cfg.family!r}")
    model = dataclasses.replace(
        _BUILDERS[cfg.family](cfg, policy, window=window), policy=policy)
    try:
        check_runnable(policy, cfg.family)
    except NotImplementedError as refusal:
        return _refusing(model, refusal)
    return model


def _refusing(model: Model, refusal: NotImplementedError) -> Model:
    """``model`` with every function raising ``refusal``; its specs and
    shapes stay (read from the unsharded functions)."""
    def refuse(*args, **kwargs):
        raise NotImplementedError(str(refusal))

    return dataclasses.replace(
        model, init=refuse, loss_fn=refuse, prefill_fn=refuse,
        decode_fn=refuse, init_decode_state=refuse,
        unsharded=model.unsharded or model)


__all__ = ["Model", "get_model", "make_train_step", "make_grad_step",
           "make_serve_step", "ShardingPolicy", "UNSHARDED", "make_policy"]
