"""Attention for the port's models: causal and sliding-window attention
for prefill, and single-token decode against a (ring) KV cache
(``repro.models.attention``).

Shapes at the signatures are the reference's: q (B, S, Hq, hd), k and v
(B, S, Hkv, hd). Prefill attention goes through
``kernels.ops.flash_attention`` (the hand-written CUDA kernel on the
card, its plain version on the CPU) in its (B, H, S, hd) layout. The
reference's binary causal decomposition and ``lax.map`` chunking exist
to keep XLA's FLOP count honest on the TPU; the kernel skips the masked
tiles itself, so they are not carried over. The decode-side cache
functions are plain torch ops, as the reference computes them outside
any Pallas kernel. All softmax math is float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def causal_attention(q, k, v, *, scale: Optional[float] = None) -> torch.Tensor:
    """Full causal self-attention (training / prefill)."""
    if q.shape[1] != k.shape[1]:
        raise ValueError("causal attention needs aligned q and kv")
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=True, scale=scale)
    return out.transpose(1, 2)


def windowed_attention(q, k, v, *, window: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Sliding-window causal attention: key j is visible from query i
    where i - window < j <= i."""
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=True, window=window,
                              scale=scale)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------
def init_cache(batch: int, cache_len: int, n_kv: int, head_dim: int, dtype,
               device) -> dict:
    """A (possibly ring) KV cache for one layer."""
    shape = (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> dict:
    """Write one token at ``pos`` (ring indexed by pos % cache_len); a
    new cache, the old one untouched, as the reference's."""
    idx = pos % cache["k"].shape[1]
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, idx:idx + 1] = k_new
    v[:, idx:idx + 1] = v_new
    return {"k": k, "v": v}


def decode_attention(q, cache: dict, pos: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against the cache.

    q (B, 1, Hq, hd); cache k/v (B, T, Hkv, hd); ``pos`` the absolute
    position of the current token (cache already updated). Valid
    entries: the first min(pos + 1, T) slots.
    """
    b, _, hq, hd = q.shape
    t, n_kv = cache["k"].shape[1], cache["k"].shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, n_kv, hq // n_kv, hd)         # (B, Hkv, G, hd)
    kc = cache["k"].float().permute(0, 2, 3, 1)              # (B, Hkv, hd, T)
    scores = torch.matmul(qg, kc) * scale                    # (B, Hkv, G, T)
    valid = torch.arange(t, device=q.device) < min(pos + 1, t)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, cache["v"].float().transpose(1, 2))  # (B, Hkv, G, hd)
    return out.reshape(b, 1, hq, hd).to(q.dtype)
