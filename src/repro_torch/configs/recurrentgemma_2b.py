"""recurrentgemma-2b — [hybrid] 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]

Griffin pattern "2r1a": (RG-LRU, RG-LRU, local-attn) repeated; 26 layers
= 8 full triples + 2 trailing recurrent blocks. head_dim=256 (Gemma
style, 10 x 256 = 2560); local attention window 2048. The port's copy
of ``repro.configs.recurrentgemma_2b``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    hybrid_pattern="2r1a",
    local_attn_window=2048,
    rglru_dim=2560,
    citation="arXiv:2402.19427",
)
