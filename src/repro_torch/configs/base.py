"""Config dataclasses of the port's model zoo.

The port's copy of ``ModelConfig`` (and the ``MoEConfig`` it names)
from ``repro.configs.base``: plain data, field for field. The model
builders in ``repro_torch.models`` consume it and the FL layer federates
it. Input shapes and the FL knobs of the reference module wait for the
slices that use them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # router load-balance auxiliary loss weight (Switch-style)
    router_aux_weight: float = 0.01
    # capacity factor used to bound expert buffers in the dense-dispatch path
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    moe: Optional[MoEConfig] = None

    # --- attention variants -------------------------------------------------
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None

    # --- hybrid (RecurrentGemma / Griffin) ----------------------------------
    hybrid_pattern: str = ""
    local_attn_window: int = 2048
    rglru_dim: Optional[int] = None  # defaults to d_model

    # --- ssm (xLSTM) ----------------------------------------------------------
    xlstm_slstm_every: int = 2
    xlstm_proj_factor: float = 2.0
    xlstm_chunk: int = 256

    # --- enc-dec (audio) ------------------------------------------------------
    n_encoder_layers: int = 0  # >0 => encoder-decoder model
    # stub modality frontend: shape of precomputed embeddings (the mlp
    # family reads its input width from frontend_dim)
    frontend_len: int = 0
    frontend_dim: int = 0

    # --- numerics / compile policy -------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    vocab_pad_multiple: int = 256
    fsdp: bool = False

    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/block structure, tiny dims."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        moe = None
        if self.moe is not None:
            moe = MoEConfig(n_experts=min(self.moe.n_experts, 4),
                            top_k=min(self.moe.top_k, 2),
                            d_ff_expert=64)
        return self.replace(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 4 * d_model) if self.d_ff else 0,
            vocab_size=512,
            moe=moe,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            frontend_len=8 if self.frontend_len else 0,
            frontend_dim=d_model if self.frontend_dim else 0,
            rglru_dim=d_model if self.rglru_dim else None,
            local_attn_window=64,
            sliding_window=64 if self.sliding_window else None,
            xlstm_chunk=16,
            remat=False,
            fsdp=False,
            vocab_pad_multiple=64,
        )
