"""stablelm-1.6b — [dense] 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b]
The port's copy of ``repro.configs.stablelm_1_6b``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
