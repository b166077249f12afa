"""Shared building blocks of the port's models: initializers, RMSNorm,
RoPE, embeddings, MLPs and the loss (``repro.models.common``).

All are plain functions over param dicts. The float32 upcasts and the
casts back to the input dtype sit where the reference puts them. Where
the reference multiplies a bfloat16 array by a Python float, JAX first
rounds the float to bfloat16 (a weak type); :func:`weak_scale` does the
same, since torch would keep the float at full precision.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.utils.trees import tree_flatten, tree_leaves, tree_map

# decode runs its batch padded to a multiple of this many rows, so a wave
# of up to DECODE_ROWS requests multiplies at one shape whatever its
# size, and each request's logits are the bits a batch of one would give
# (BLAS and torch's reductions choose their order of sums by shape;
# prefill gets the same from matmul's per-sequence products)
DECODE_ROWS = 8


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (the LLaMA/PaLM convention): a
    standard normal cut to [-3, 3], times ``scale`` or 1/sqrt(fan_in).

    Drawn on the generator's device (a CPU generator gives the same
    numbers on every device; a CUDA one draws on the card, which is what
    a multi-billion-parameter init needs); it follows
    ``repro.models.common.dense_init`` in distribution, not in bits —
    ``jax.random`` is another stream. Without a generator, an empty
    meta tensor of the shape (``Model.param_shapes``).
    """
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return x.mul_(std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    return x.normal_(generator=generator).mul_(0.02).to(dtype)


def init_stacked(make, n: int):
    """``n`` trees from ``make()``, drawn in order, stacked on a leading
    dim (the reference's ``jax.vmap`` of an init over ``n`` keys). Each
    tree is copied into its slot as soon as it is drawn, so the peak is
    the stack and one tree; ``n`` = 0 still draws one, and gives a
    leading dim of 0, as ``jax.vmap`` over no keys does."""
    first = make()
    leaves = tree_leaves(first)
    # the structure alone: tree_flatten's rebuild keeps the leaves it saw
    _, rebuild = tree_flatten(tree_map(lambda x: None, first))
    del first
    out = [torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
           for x in leaves]
    for i in range(n):
        if i:
            leaves = tree_leaves(make())
        for slot, x in zip(out, leaves, strict=True):
            slot[i].copy_(x)
        leaves = None      # freed before the next tree is drawn
    return rebuild(out)


def weak_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` with ``s`` rounded to ``x``'s dtype first, as JAX does
    for a Python scalar."""
    return x * torch.tensor(s, dtype=x.dtype)   # a host scalar: no copy


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a fill on the device: a host tensor copied there would wait for the
    # device's queue (a pageable copy synchronises the stream)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                device) -> tuple:
    """(cos, sin) of RoPE's angles at ``positions`` (broadcastable to
    (..., S), on ``device``: from the host they would be a synchronising
    copy), each (..., S, 1, head_dim // 2) float32. They depend on the
    positions only, so a stack of layers computes them once."""
    freqs = rope_frequencies(head_dim, theta, device)          # (half,)
    angles = positions.to(device, torch.float32)[..., None] * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """x (..., S, H, head_dim) rotated by :func:`rope_tables`."""
    cos, sin = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta, x.device))


# ---------------------------------------------------------------------------
# Embedding / unembedding (padded vocab)
# ---------------------------------------------------------------------------
def init_embedding(generator, vocab_padded: int, d_model: int, dtype,
                   device) -> dict:
    return {"table": embed_init(generator, (vocab_padded, d_model),
                                dtype).to(device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def init_unembed(generator, vocab_padded: int, d_model: int, dtype,
                 device) -> dict:
    return {"proj": dense_init(generator, (d_model, vocab_padded),
                               dtype).to(device)}


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum``
    promotes mixed bfloat16/float32 operands.

    A (B, S, K) ``x`` with S > 1 is multiplied one sequence at a time, as
    B products of (S, K) x (K, N). BLAS libraries (cuBLAS, the host's)
    pick a kernel, and with it the order of the sums, by the product's
    shape, so this way a sequence's prefill gives the same bits whatever
    else shares its batch (the serving scheduler's batched == serial
    property; tests/test_torch_hybrid.py). At S >= 1024 each product
    still fills the card. Under autograd the per-sequence products are
    stacked (the same products, so the same bits).
    """
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if x.dim() != 3 or x.shape[0] == 1 or x.shape[1] == 1:
        return torch.matmul(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return torch.stack([torch.matmul(x[b], w) for b in range(x.shape[0])])
    out = torch.empty(x.shape[:2] + (w.shape[-1],), dtype=dt, device=x.device)
    for b in range(x.shape[0]):
        torch.matmul(x[b], w, out=out[b])
    return out


def pad_rows(x: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to ``rows``."""
    extra = rows - x.shape[dim]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def row_bucket(b: int) -> int:
    """``b`` rounded up to a multiple of :data:`DECODE_ROWS`."""
    return -(-b // DECODE_ROWS) * DECODE_ROWS


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits over the padded vocab (``x`` times the
    embedding table, transposed)."""
    return matmul(x, params["table"].t())


def unembed_untied(params: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, params["proj"])


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------
def init_swiglu(generator, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype).to(device),
        "w_up": dense_init(generator, (d_model, d_ff), dtype).to(device),
        "w_down": dense_init(generator, (d_ff, d_model), dtype).to(device),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(matmul(x, params["w_gate"]))
    up = matmul(x, params["w_up"])
    return matmul(gate * up, params["w_down"])


def init_geglu(generator, d_model: int, d_ff: int, dtype, device) -> dict:
    return init_swiglu(generator, d_model, d_ff, dtype, device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def geglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = gelu(matmul(x, params["w_gate"]))
    up = matmul(x, params["w_up"])
    return matmul(g * up, params["w_down"])


def init_mlp(generator, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "w_up": dense_init(generator, (d_model, d_ff), dtype).to(device),
        "w_down": dense_init(generator, (d_ff, d_model), dtype).to(device),
    }


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = gelu(matmul(x, params["w_up"]))
    return matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy with padded-vocab masking. logits (..., V_pad)."""
    logits = logits.float()
    v_pad = logits.shape[-1]
    if v_pad > vocab_size:
        ids = torch.arange(v_pad, device=logits.device)
        logits = torch.where(ids < vocab_size, logits, -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
