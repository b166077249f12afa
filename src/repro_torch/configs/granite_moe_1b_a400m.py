"""granite-moe-1b-a400m — [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
The port's copy of ``repro.configs.granite_moe_1b_a400m``, field for field.

vocab 49155 is not divisible by the model axis — padded to 49408.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
