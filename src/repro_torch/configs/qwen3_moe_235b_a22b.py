"""qwen3-moe-235b-a22b — [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family]
The port's copy of ``repro.configs.qwen3_moe_235b_a22b``, field for field.

d_ff=1536 is the per-expert intermediate dim (Qwen3-MoE convention);
head_dim is the Qwen3 decoupled 128 (q-proj is n_heads*head_dim wide).
Every layer is MoE. About 0.94 TB of float32 params: one card holds it
only at a depth cut.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1_000_000.0,
    fsdp=True,
    citation="hf:Qwen/Qwen3-30B-A3B",
)
