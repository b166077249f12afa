"""Attention for the port's models: causal, sliding-window and
bidirectional attention over one sequence, dense attention of queries
over keys of another length (cross-attention), and single-token decode
against a (ring) KV cache (``repro.models.attention``).

Shapes at the signatures are the reference's: q (B, S, Hq, hd), k and v
(B, S, Hkv, hd). Prefill attention goes through
``kernels.ops.flash_attention`` (the hand-written CUDA kernel on the
card, its plain version on the CPU) in its (B, H, S, hd) layout. The
reference's binary causal decomposition and ``lax.map`` chunking exist
to keep XLA's FLOP count honest on the TPU; the kernel skips the masked
tiles itself, so they are not carried over. The encoder's bidirectional
self-attention is the same kernel with ``causal=False``. Dense
attention (the reference's ``_attend_dense`` unmasked, which serves
``encdec.py``'s cross-attention, where the query and key lengths
differ, a shape neither the TPU kernel nor the port's takes) and the
decode-side cache functions are plain torch ops, as the reference
computes them outside any Pallas kernel. All softmax math is float32.
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


def bidirectional_attention(q, k, v, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Full (unmasked) self-attention over one sequence: every key is
    visible from every query (the encoder's)."""
    if q.shape[1] != k.shape[1]:
        raise ValueError("bidirectional attention needs aligned q and kv")
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=False, scale=scale)
    return out.transpose(1, 2)


def _dense(q, k, v, scale: float) -> torch.Tensor:
    """q (B, Sq, Hq, hd) over k, v (B, Sk, Hkv, hd), unmasked, as the
    reference's ``_attend_dense`` then ``_finalize``: float32 scores,
    exp against the row max, the unnormalised sum of p·v divided by the
    row's sum of p."""
    b, sq, hq, hd = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    qg = q.float().reshape(b, sq, n_kv, g, hd).permute(0, 2, 3, 1, 4) \
        .reshape(b, n_kv, g * sq, hd)                    # (B, Hkv, G*Sq, hd)
    scores = torch.matmul(qg, k.float().permute(0, 2, 3, 1)) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float().transpose(1, 2))    # (B, Hkv, G*Sq, hd)
    out = out / torch.clamp_min(denom, 1e-30)
    out = out.reshape(b, n_kv, g, sq, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def dense_attention(q, k, v, *, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """GQA attention of q (B, Sq, Hq, hd) over k, v (B, Sk, Hkv, hd) of
    any other length, no mask (cross-attention); the output in q's dtype.

    Queries of more than one position are attended one sequence at a
    time, as ``common.matmul`` multiplies them, so a sequence's bits do
    not depend on its wave; single-position queries (decode, its rows
    padded to ``common.DECODE_ROWS`` by the caller) in one product."""
    if q.shape[0] != k.shape[0] or tuple(k.shape) != tuple(v.shape) \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"dense attention takes q (B, Sq, Hq, hd) and k, v "
                         f"(B, Sk, Hkv, hd) with Hq % Hkv == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.shape[0] == 1 or q.shape[1] == 1:
        return _dense(q, k, v, scale)
    return torch.cat([_dense(q[i:i + 1], k[i:i + 1], v[i:i + 1], scale)
                      for i in range(q.shape[0])])


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
