"""seamless-m4t-large-v2 — [audio] 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal.  [arXiv:2308.11596]
The port's copy of ``repro.configs.seamless_m4t_large_v2``, field for
field.

Backbone only: the mel-spectrogram/conformer feature frontend is a
STUB — the batch's ``frontend`` carries precomputed frame embeddings
(frontend_len x d_model). The 24 layers split 12 encoder + 12 decoder;
the decoder cross-attends the encoder output. vocab 256206 is padded to
a multiple of 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,    # encoder layers (12 + 12 = 24L)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    frontend_len=1024,      # precomputed audio-frame embeddings per example
    frontend_dim=1024,
    citation="arXiv:2308.11596",
)
