"""xlstm-1.3b — [ssm] 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks.  [arXiv:2405.04517]
The port's copy of ``repro.configs.xlstm_1_3b``, field for field.

d_ff=0: each xLSTM block carries its own up/down projection
(proj_factor=2). Blocks alternate mLSTM / sLSTM (xlstm_slstm_every=2 =>
every 2nd block is sLSTM), matching the paper's mixed stack. mLSTM uses
a chunkwise-parallel form (chunk=256) so training over 4k tokens is a
16-step loop over chunks, not a 4096-step one; sLSTM is a true
elementwise recurrence, a loop over time.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    xlstm_slstm_every=2,
    xlstm_proj_factor=2.0,
    xlstm_chunk=256,
    citation="arXiv:2405.04517",
)
