"""minitron-8b — [dense] 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron.  [arXiv:2407.14679]
The port's copy of ``repro.configs.minitron_8b``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=256_000,
    fsdp=True,
    citation="arXiv:2407.14679",
)
