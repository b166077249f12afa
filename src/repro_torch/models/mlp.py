"""The paper's own workload: a ~1.8M-parameter MLP classifier
(Sec. IV-C docker experiment). 784 -> 768 -> 768 -> 768 -> 10.

The port of ``repro.models.mlp``. Params keep the reference's layout,
``{"layers": [{"w": (din, dout), "b": (dout,)}, ...]}``, so a JAX param
tree crosses over key for key (``core.state.params_from_numpy``). The
forward also takes a client-stacked tree — every leaf with a leading
``C`` dim, and inputs ``(C, B, din)`` — which is how the batched round
engine trains all clients in one call: the products become batched
matrix products, one per client.

Matmuls run in float32: the orchestrator turns TF32 off on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default),
as the reference's float32 ``jnp`` matmuls are full float32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.api import Model
from repro_torch.models.sharding import UNSHARDED, P, ShardingPolicy


def init_mlp_params(generator: torch.Generator, cfg: ModelConfig,
                    device="cuda") -> dict:
    dims = [cfg.frontend_dim] + [cfg.d_model] * cfg.n_layers + [cfg.vocab_size]
    dtype = getattr(torch, cfg.param_dtype)
    dev = resolve_device(device)
    layers = []
    for din, dout in zip(dims[:-1], dims[1:], strict=True):
        layers.append({
            "w": common.dense_init(generator, (din, dout), dtype).to(dev),
            "b": torch.zeros((dout,), dtype=dtype, device=dev),
        })
    return {"layers": layers}


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """(..., B, din) -> (..., B, n_classes); a leading client dim on the
    params pairs with the same dim on ``x``."""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = torch.matmul(h, layer["w"]) + layer["b"].unsqueeze(-2)
        if i < n - 1:
            h = torch.relu(h)
    return h


def mlp_loss(params, batch) -> tuple:
    """Mean cross-entropy (logsumexp minus the gold logit) and argmax
    accuracy over the batch dim, in float32."""
    logits = mlp_forward(params, batch["x"]).float()
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    loss = torch.mean(logz - gold, dim=-1)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float(), dim=-1)
    return loss, {"acc": acc}


def build_mlp_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
                    window=None) -> Model:
    """The MLP; ``window`` is taken and ignored, as the reference's
    builder does; its spec rule replicates every param (1.8M of them)."""

    def spec_rule(path: str, shape):
        if policy.mesh is None:
            return P()
        return P(*([None] * len(shape)))

    return Model(
        config=cfg,
        init=lambda generator, device="cuda": init_mlp_params(
            generator, cfg, device),
        loss_fn=mlp_loss, policy=policy, spec_rule=spec_rule,
    )
