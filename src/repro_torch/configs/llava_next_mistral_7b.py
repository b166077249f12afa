"""llava-next-mistral-7b — [vlm] 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]
The port's copy of ``repro.configs.llava_next_mistral_7b``, field for
field.

Backbone only: the SigLIP/CLIP vision tower + projector is a STUB —
the batch's ``frontend`` carries projected patch embeddings
(frontend_len x d_model), prepended to the token embeddings
(anyres tiling => up to 5 tiles x 576 patches = 2880 image tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    frontend_len=2880,      # anyres: 5 tiles x 576 patches
    frontend_dim=4096,
    rope_theta=1_000_000.0,
    fsdp=True,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
