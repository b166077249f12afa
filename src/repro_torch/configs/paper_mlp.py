"""paper-mlp-1m8 — the paper's own workload: a multi-layer perceptron with
~1.8M parameters used in the docker-based SDFLMQ experiment (Sec. IV-C).

A 3-hidden-layer MLP classifier: 784 -> 768 -> 768 -> 768 -> 10 gives
784*768 + 768*768*2 + 768*10 + biases = 1,791,754 parameters, matching
the paper's "1.8 million parameters".
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-mlp-1m8",
    family="mlp",
    n_layers=3,
    d_model=768,
    n_heads=1,
    n_kv_heads=1,
    d_ff=768,
    vocab_size=10,        # classes
    frontend_len=784,     # input features (MNIST-like)
    frontend_dim=784,
    citation="paper Sec. IV-C (SDFLMQ docker experiment)",
)

# CI-sized stand-in (~55k params): same workload shape, a fraction of the
# flops — the emulated smoke jobs federate this so runs with dozens of
# clients finish in seconds on a CPU runner
CONFIG_SMOKE = ModelConfig(
    name="mlp-smoke",
    family="mlp",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=64,
    vocab_size=10,
    frontend_len=784,
    frontend_dim=784,
    citation="CI smoke variant of paper-mlp-1m8",
)
