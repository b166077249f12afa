"""Plain PyTorch versions of the port's kernels (TPD, FedAvg, fused
AdamW, flash attention and the RG-LRU scan, with the backward passes of
the last two).

Each function here computes what its kernel computes, on any device, in
torch ops. The CPU tests run them, ``chip_smoke.py`` holds each kernel
against them on the card, and a kernel wrapper hands them every tensor
that lies on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def tpd_ref(placements, attrs, leaf_load, kids, level_starts,
            penalty: float = 0.0) -> torch.Tensor:
    """Batched TPD (paper eqs. 6-7) in torch ops; the operands of
    ``kernels.tpd.batch_tpd_cuda``.

    placements (P, D) int32; attrs (3, C) f32 = [mdatasize, pspeed,
    memcap]; leaf_load (P, L) f32 trainer loads per leaf aggregator;
    kids (D, W) int32 child slots, -1 padded, and level_starts, depth + 1
    host ints, from ``kernels.tpd.tpd_kernel_inputs`` (level ``l`` is the
    slot range ``level_starts[l]:level_starts[l + 1]``; the last level
    holds the L leaves) -> (P,) f32 TPDs.

    Additions run in a fixed order: the child sum over the W kid
    columns left to right, and the level maxima deepest level first.
    For W < 8 that is numpy's order too, so the result equals the
    reference's float32 numpy evaluator bit for bit.
    """
    p = placements.long()
    bounds = [int(b) for b in level_starts]
    leaf_start = bounds[-2]
    mds, pspeed, memcap = attrs.float().unbind(0)
    k = kids[:leaf_start].long()
    kid_mds = torch.where(k >= 0, mds[p[:, k.clamp_min(0)]], 0.0)
    child = kid_mds[..., 0]                          # (P, D - L)
    for w in range(1, kid_mds.shape[-1]):
        child = child + kid_mds[..., w]
    load = mds[p] + torch.cat([child, leaf_load.float()], dim=1)
    delay = load / pspeed[p]
    if penalty > 0:
        cap = memcap[p]
        over = torch.clamp_min(load - cap, 0.0)
        delay = delay * (1.0 + penalty * over / torch.clamp_min(cap, 1e-9))
    total = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    for lv in range(len(bounds) - 2, -1, -1):        # deepest level first
        total = total + delay[:, bounds[lv]:bounds[lv + 1]].amax(dim=1)
    return total


# ---------------------------------------------------------------------------
# weighted FedAvg: out[g] = sum_k w[g, k] * x[g, k], float32 accumulation,
# the terms added in k order (each product rounded before its add), the
# result in the input dtype
# ---------------------------------------------------------------------------
def fedavg_rows_ref(pool, rows, w, out=None) -> torch.Tensor:
    """Row-indexed FedAvg, the operands of ``kernels.fedavg.fedavg_rows``.

    pool (R, N) f32 or bf16; rows (G, K) int32 row ids into the pool, -1
    where a cluster has fewer than K members; w (G, K) f32 -> (G, N) in
    the pool's dtype (written into ``out`` when given). A -1 entry adds
    nothing, whatever its weight.
    """
    rows = torch.as_tensor(rows).to(pool.device).long()
    w = torch.as_tensor(w).to(pool.device, torch.float32)
    acc = torch.zeros((rows.shape[0], pool.shape[1]), dtype=torch.float32,
                      device=pool.device)
    for k in range(rows.shape[1]):
        r = rows[:, k]
        term = pool[r.clamp_min(0)].float() * w[:, k:k + 1]
        acc = torch.where((r >= 0)[:, None], acc + term, acc)
    if out is None:
        return acc.to(pool.dtype)
    return out.copy_(acc)


def fedavg_batched_ref(stacked, w) -> torch.Tensor:
    """stacked (G, K, N), w (G, K) -> (G, N): one weighted sum per
    cluster (``kernels.fedavg.fedavg_batched``'s operands)."""
    w = w.float()
    acc = torch.zeros((stacked.shape[0], stacked.shape[2]),
                      dtype=torch.float32, device=stacked.device)
    for k in range(stacked.shape[1]):
        acc = acc + stacked[:, k].float() * w[:, k:k + 1]
    return acc.to(stacked.dtype)


def fedavg_ref(stacked, weights) -> torch.Tensor:
    """stacked (K, N), weights (K,) -> (N,) = sum_k w_k * stacked_k
    (``kernels.fedavg.fedavg``'s operands)."""
    w = weights.float()
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for k in range(stacked.shape[0]):
        acc = acc + stacked[k].float() * w[k]
    return acc.to(stacked.dtype)


# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------
def fused_adamw_ref(p, g, m, v, lr, bc1, bc2, *, b1=0.9, b2=0.95, eps=1e-8,
                    wd=0.1):
    """One AdamW step over flat p, g (p's dtype) and m, v (float32), the
    operands of ``kernels.fused_adamw.fused_adamw``; returns new (p, m,
    v), the inputs untouched (``repro.kernels.ref.fused_adamw_ref``).

    float32 math in the reference's order, every operation rounded on
    its own: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p -= lr
    (m / bc1 / (sqrt(v / bc2) + eps) + wd p). The scalars are float32
    (a Python float is rounded to float32 first, as JAX rounds a weak
    scalar) and enter as 0-dim tensors on p's device, so a division by
    ``bc1`` or ``bc2`` is a true division on the card too (torch's CUDA
    division by a host scalar multiplies by its reciprocal). The square
    root is taken in float64 and rounded once to float32, the correctly
    rounded float32 root on every device: torch's float32 ``sqrt`` on a
    CPU with AVX-512 is not (it differs from IEEE in about 1 of 6
    elements by an ulp).
    """
    def f32(x):
        return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                            device=p.device)

    p32, g32 = p.float(), g.float()
    m = f32(b1) * m + f32(1 - b1) * g32
    v = f32(b2) * v + f32(1 - b2) * (g32 * g32)
    mhat = m / f32(bc1)
    vhat = v / f32(bc2)
    root = torch.sqrt(vhat.double()).float()
    delta = mhat / (root + f32(eps)) + f32(wd) * p32
    return (p32 - f32(lr) * delta).to(p.dtype), m, v


# ---------------------------------------------------------------------------
# attention and the linear recurrence
# ---------------------------------------------------------------------------
def _attention_mask(s: int, causal: bool, window: Optional[int],
                    kv_len: Optional[int], device) -> torch.Tensor:
    """(S, S) bool: key j (column) visible from query i (row)."""
    i = torch.arange(s, device=device)
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    if kv_len is not None:
        mask &= (i < kv_len)[None, :]
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None,
                        return_lse: bool = False):
    """Dense-softmax attention, the operands of
    ``kernels.flash_attention.flash_attention``.

    q (B, Hq, S, hd); k, v (B, Hkv, S, hd), Hq a multiple of Hkv (query
    head h reads kv head h // (Hq / Hkv)) -> like q. Key j is visible
    from query i where j <= i (``causal``), j > i - window (``window``)
    and j < kv_len (``kv_len``). Math in float32, the output in q's
    dtype. A query row that sees no key at all comes out 0, as the TPU
    kernel's guard makes it (``repro/kernels/flash_attention.py:86-89``);
    every other row is the plain softmax.

    With ``return_lse`` it returns ``(out, lse)``, lse (B, Hq, S)
    float32 the log of each row's softmax denominator, max included:
    m + log(max(sum_j exp(s_j - m), 1e-30)), what the backward
    recomputes the probabilities from.
    """
    b, hq, s, hd = q.shape
    g = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = torch.repeat_interleave(k, g, dim=1).float()
    vv = torch.repeat_interleave(v, g, dim=1).float()
    scores = torch.matmul(q.float(), kk.transpose(-1, -2)) * scale
    mask = _attention_mask(s, causal, window, kv_len, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.clamp_min(scores.amax(dim=-1, keepdim=True), NEG_INF / 2)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    denom = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = (torch.matmul(p, vv) / denom).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom))[..., 0]
    return out


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            kv_len: Optional[int] = None):
    """dq, dk, dv of :func:`flash_attention_ref` under the same masks,
    the operands of ``kernels.flash_attention.flash_attention_bwd``.

    out and lse are the forward's; dout is like q. The probabilities
    are recomputed from lse, P = exp(scale q.k - lse) on the visible
    pairs, and D = rowsum(dout * out):
    dv = P^T dout, dS = P (dout v^T - D), dq = scale dS k,
    dk = scale dS^T q, dk and dv summed over each kv head's query
    heads. float32 math; each gradient in its input's dtype.
    """
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q32, do = q.float(), dout.float()
    kk = torch.repeat_interleave(k, g, dim=1).float()
    vv = torch.repeat_interleave(v, g, dim=1).float()
    mask = _attention_mask(s, causal, window, kv_len, q.device)
    scores = torch.matmul(q32, kk.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(scores - lse.float()[..., None]), 0.0)
    d = torch.sum(do * out.float(), dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, vv.transpose(-1, -2)) - d)
    dq = torch.matmul(ds, kk) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), q32) * scale).view(
        b, hkv, g, s, hd).sum(dim=2)
    dv = torch.matmul(p.transpose(-1, -2), do).view(b, hkv, g, s, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan_ref(a, u, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gated linear recurrence h_t = a_t * h_{t-1} + u_t, in time
    order, the operands of ``kernels.rglru.rglru_scan``.

    a, u (B, T, D) -> h (B, T, D) in a's dtype; float32 math, each
    product rounded before its add. ``h0`` (B, D), when given, is folded
    into the first step: h_0 = a_0 * h0 + u_0 (the kernel starts from 0;
    callers fold ``h0`` into ``u`` themselves).
    """
    if a.shape[1] == 0:
        return torch.empty_like(a)
    a32, u32 = a.float(), u.float()
    h = torch.zeros_like(a32[:, 0]) if h0 is None else h0.float()
    hs = []
    for t in range(a32.shape[1]):
        h = a32[:, t] * h + u32[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rglru_scan_bwd_ref(a, h, dh):
    """The adjoint of the scan (h_{-1} = 0), the operands of
    ``kernels.rglru.rglru_scan_bwd``: a, h (the forward's output) and dh
    (the loss's gradient with respect to h), all (B, T, D) -> (da, du).

    Backward in time from the last step: g_t = dh_t + a_{t+1} g_{t+1}
    (the product rounded before its add), du_t = g_t and da_t = g_t
    h_{t-1}; float32 math, the outputs in a's dtype.
    """
    a32, h32, dh32 = a.float(), h.float(), dh.float()
    da = torch.empty_like(a32)
    du = torch.empty_like(a32)
    n = a32.shape[1]
    carry = torch.zeros_like(a32[:, 0])
    for t in range(n - 1, -1, -1):
        a_next = a32[:, t + 1] if t + 1 < n else torch.zeros_like(carry)
        carry = a_next * carry + dh32[:, t]
        du[:, t] = carry
        h_prev = h32[:, t - 1] if t > 0 else torch.zeros_like(carry)
        da[:, t] = carry * h_prev
    return da.to(a.dtype), du.to(a.dtype)
